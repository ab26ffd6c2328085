"""Model zoo: decoders of attention, Mamba and xLSTM blocks, dense or MoE,
the encoder-decoder and the VLM's text stack; the full-sequence forward
and loss, and prefill and decode on a contiguous cache."""
from repro_torch.models.model import (  # noqa: F401
    abstract_cache, cache_spec, decode_step, encode, forward, init_cache,
    init_params, prefill, train_loss)
