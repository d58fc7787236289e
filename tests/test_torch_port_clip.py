"""The training step's global-norm clip (``train/step.py::
clip_by_global_norm_``, run by ``Optimizer.step``) against
``optax.clip_by_global_norm``, the JAX step's first link, on the CPU.

Every dtype takes optax's form: a gradient is kept where ``norm < clip``,
else it becomes ``(g / norm) * clip``. The port computes it as ``g / d *
f`` with (d, f) = (1, 1) or (norm, clip) in one foreach pass, which must be
bit-equal to ``torch.where(norm < clip, g, g / norm * clip)`` wherever
``clip`` is exact in the gradients' dtype (3.0, the trainer's default), on
a clipping step and on a step that keeps the gradients. Against optax (its
update jitted, as the JAX step runs it): 16-bit gradients bit-equal (the
port's ``global_norm`` rounds as ``optax.global_norm`` does, and ``clip``
is rounded to the gradients' dtype as JAX's weak typing rounds it, so a
clip of 0.7 at bf16 is bf16's 0.69921875); fp32 within NORM_RTOL, the
two norms being sums of squares taken in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mt3d_resenc_unet_torch.train.step import (Optimizer, clip_by_global_norm_,
                                               global_norm)

SHAPES = ((3, 3, 3, 8, 16), (64, 64), (16,), (5, 7))
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
CLIP = 3.0
# fp32 against optax: the norms differ by a few ulps of a sum of ~40k
# squares (torch's per-tensor norms against XLA's sums), and so each
# clipped value
NORM_RTOL = 1e-6


def _grads(scale, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * scale)
                             .astype(np.float32)).to(dtype) for s in SHAPES]


def _norm(grads):
    """The norm ``Optimizer.step`` clips by."""
    if grads[0].dtype == torch.float32:
        return torch.nn.utils.get_total_norm(grads)
    return global_norm(grads)


def _optax(grads, clip, jdtype):
    tx = optax.clip_by_global_norm(clip)
    leaves = [jnp.asarray(g.float().numpy()).astype(jdtype) for g in grads]
    out, _ = jax.jit(tx.update)(leaves, tx.init(leaves))
    return [torch.from_numpy(np.array(o.astype(jnp.float32))) for o in out]


@pytest.mark.parametrize("clipping", [True, False],
                         ids=["clipping", "keeping"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_clip_is_the_where_form_bit_for_bit(dtype, clipping):
    td = DTYPES[dtype][0]
    grads = _grads(0.1 if clipping else 1e-3, td)
    norm = _norm(grads)
    assert bool(norm >= CLIP) == clipping, float(norm)
    want = [torch.where(norm < CLIP, g, g / norm * CLIP) for g in grads]
    got = [g.clone() for g in grads]
    clip_by_global_norm_(got, norm, CLIP)
    for a, b, g in zip(got, want, grads):
        assert a.dtype == td
        assert torch.equal(a, b)
        if not clipping:
            assert torch.equal(a, g)


@pytest.mark.parametrize("clip", [CLIP, 0.7])
@pytest.mark.parametrize("clipping", [True, False],
                         ids=["clipping", "keeping"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_clip_matches_optax(dtype, clipping, clip):
    td, jd = DTYPES[dtype]
    grads = _grads(0.1 if clipping else 1e-3, td, seed=1)
    norm = _norm(grads)
    assert bool(norm >= clip) == clipping, float(norm)
    got = [g.clone() for g in grads]
    clip_by_global_norm_(got, norm, clip)
    want = _optax(grads, clip, jd)
    for a, b in zip(got, want):
        if td == torch.float32 and clipping:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=NORM_RTOL,
                                       atol=0)
        else:
            assert torch.equal(a.float(), b)


@pytest.mark.parametrize("clipping", [True, False],
                         ids=["clipping", "keeping"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_optimizer_step_clips_then_updates(dtype, clipping):
    """``Optimizer.step`` returns the norm before the clip and hands the
    clipped gradients to the torch optimizer (SGD at lr 0 leaves both the
    parameters and their gradients as the clip made them)."""
    td = DTYPES[dtype][0]
    grads = _grads(0.1 if clipping else 1e-3, td, seed=2)
    params = [torch.nn.Parameter(torch.zeros_like(g)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = g.clone()
    opt = Optimizer(torch.optim.SGD(params, lr=0.0), lambda step: 0.0, CLIP)
    norm = opt.step()
    assert torch.equal(norm, _norm(grads))
    for p, g in zip(params, grads):
        assert torch.equal(p.grad, torch.where(norm < CLIP, g,
                                               g / norm * CLIP))
        assert not p.detach().any()
