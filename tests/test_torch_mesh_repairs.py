"""The places the port's model makes a reshard explicit for DTensor (the
dry-run's fake process groups, `launch.dryrun`) leave plain tensors as
they were, on the CPU.

With no process group, `shardctx` of a production mesh (the port's
`AbstractMesh`, (16, 16)) changes nothing on plain tensors: `constrain`
is an identity there, and so are the head splits (`unflatten`), the
row-parallel alignment of `linear` (`align_contraction`), the residual
stream's constraint and the loss's, and each of `parallel.sharding`'s
DTensor helpers (the decode softmax, the label pick, the cache write,
the micro-batch slice). Reduced llama31-8b and whisper-base
(f32): a prefill, a decode step, and the training loss with its
gradients, with and without the context, are equal bit for bit; the
helpers are the plain operations on plain tensors.
"""
import pytest
import torch

from repro_torch.configs import reduced
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models import attention as attn
from repro_torch.models.model import train_loss
from repro_torch.parallel.sharding import (
    AbstractMesh, align_contraction, is_dtensor, micro_batch, shardctx,
    softmax, split_last, take_last, unflatten, write_rows)

MESH = AbstractMesh((16, 16), ("data", "model"))


def _run(cfg, params, batch, frames):
    with torch.no_grad():
        logits, cache = prefill(params, cfg, batch, max_len=12)
        token = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        step, cache = decode_step(params, cfg, token, cache)
    leaves = [p for lyr in params["layers"] for p in lyr.get(
        "attn", lyr.get("mamba", {})).values() if torch.is_tensor(p)]
    for p in leaves:
        p.requires_grad_(True)
    tb = dict(batch, labels=torch.roll(batch["tokens"], -1, 1))
    loss, _ = train_loss(params, cfg, tb, remat=False)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return [logits, step, loss] + list(grads) + [
        c[n] for c in cache["layers"] for n in sorted(c)]


@pytest.mark.parametrize("arch", ["llama31-8b", "whisper-base"])
def test_prefill_decode_and_grads_are_unchanged_under_shardctx(arch):
    cfg = reduced(arch, vocab=1024)
    params = init_params(cfg, device="cpu", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, 1000, (2, 8), generator=g,
                                     dtype=torch.int32)}
    frames = None
    if cfg.encoder_layers:
        frames = torch.randn(2, cfg.frontend_len, cfg.d_model, generator=g)
        batch["frames"] = frames
    plain = _run(cfg, params, batch, frames)
    with shardctx(MESH):
        meshed = _run(cfg, params, batch, frames)
    assert len(plain) == len(meshed) > 5
    for a, b in zip(plain, meshed):
        assert torch.equal(a, b)


def test_helpers_are_the_plain_operations_on_plain_tensors():
    x = torch.randn(3, 5, 24)
    w = torch.randn(24, 7)
    with shardctx(MESH):
        assert torch.equal(split_last(x, 8, 3), x.reshape(3, 5, 8, 3))
        assert torch.equal(unflatten(x, 1, (5, 1)), x.reshape(3, 5, 1, 24))
        assert align_contraction(x, w) is x
        assert torch.equal(micro_batch(x, 1, 1, 3), x[1:2])
        assert torch.equal(softmax(x, -1), torch.softmax(x, dim=-1))
        idx = torch.randint(0, 24, (3, 5))
        assert torch.equal(take_last(x, idx),
                           torch.gather(x, -1, idx[..., None])[..., 0])
        assert not is_dtensor(x)
    kc, vc = torch.zeros(2, 2, 6, 4), torch.zeros(2, 2, 6, 4)
    k, v = torch.randn(2, 1, 2, 4), torch.randn(2, 1, 2, 4)
    nk, nv = attn.update_cache(kc, vc, k, v, torch.tensor([1, 5]))
    assert torch.equal(nk[0, :, 1], k[0, 0]) and torch.equal(nv[1, :, 5],
                                                             v[1, 0])
    assert int((nk != 0).sum()) == k.numel()      # nothing else written
    assert torch.equal(write_rows(kc, k, torch.tensor([1, 5])), nk)
    assert not kc.any()                           # the given one untouched
