"""The port's flash attention (skypilot_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernels, on the CPU.

Inputs come from numpy with a seed and go to both sides. The JAX side runs
its kernels in interpret mode, as tests/test_flash_attention.py does; the
port side runs the kernels' plain versions, which is what a CPU tensor
gets. Tolerances are the JAX tests' own: 2e-3 for outputs and lse, 5e-3
for gradients (f32 on both sides; the gap is summation order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops.pallas import flash_attention as fa_jax
from skypilot_tpu_torch.ops import flash_attention as fa_torch

OUT_TOL = 2e-3
GRAD_TOL = 5e-3


def _qkv(seed, b=2, s=256, h=4, kvh=2, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]


def _jax_flash(q, k, v, causal):
    return fa_jax.flash_attention(q, k, v, causal=causal, block_q=64,
                                  block_k=64)


@pytest.mark.parametrize("causal,s,seed", [(True, 256, 0), (False, 256, 1),
                                           (True, 128, 2)])
def test_outputs_match_jax(causal, s, seed):
    q, k, v = _qkv(seed, s=s)
    ref = np.asarray(_jax_flash(*map(jnp.asarray, (q, k, v)), causal))
    out = fa_torch.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal):
    q, k, v = _qkv(3, s=128)
    gj = jax.grad(lambda q, k, v: jnp.sum(_jax_flash(q, k, v, causal) ** 2),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa_torch.flash_attention(qt, kt, vt, causal=causal)
    gt = torch.autograd.grad((out ** 2).sum(), (qt, kt, vt))
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_irregular_shape_falls_back(monkeypatch):
    # seq 100: no 8-aligned block divides it, so both packages take their
    # reference path; the port's kernel op must not run.
    q, k, v = _qkv(4, s=100)
    ref = np.asarray(_jax_flash(*map(jnp.asarray, (q, k, v)), True))

    def no_kernel(*args):
        raise AssertionError("kernel path taken for an irregular shape")

    monkeypatch.setattr(fa_torch._FlashAttention, "apply", no_kernel)
    out = fa_torch.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=OUT_TOL, atol=OUT_TOL)


# The resident family's lse is natural-log, the triangular family's base 2;
# the port's is natural-log, so the tri value is scaled by ln 2.
@pytest.mark.parametrize("resident,to_natural", [(True, 1.0),
                                                 (False, math.log(2.0))])
def test_lse_matches_jax(monkeypatch, resident, to_natural):
    q, k, v = _qkv(5, s=256)
    scale = q.shape[-1] ** -0.5
    monkeypatch.setattr(fa_jax, "_use_resident", lambda s, d: resident)
    o_j, lse_j = fa_jax._flash_fwd(*map(jnp.asarray, (q, k, v)), causal=True,
                                   scale=scale, block_q=64, block_k=64,
                                   keep_lse_pad=False)
    o_t, lse_t = fa_torch.flash_fwd_plain(*map(torch.from_numpy, (q, k, v)),
                                          True, scale)
    np.testing.assert_allclose(lse_t.numpy(),
                               np.asarray(lse_j) * to_natural,
                               rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=OUT_TOL,
                               atol=OUT_TOL)


@pytest.mark.parametrize("wrapper", ["flash_fwd", "flash_dq", "flash_dkv",
                                     "flash_fwd_tri", "flash_dq_tri",
                                     "flash_dkv_tri", "flash_fwd_streamed",
                                     "flash_dq_streamed",
                                     "flash_dkv_streamed"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    # A kernel wrapper launches its kernel or raises; it never computes the
    # plain version itself. (The plain path is chosen above it, by device.)
    # The triangular wrappers are causal only and take no causal flag.
    q, k, v = map(torch.from_numpy, _qkv(6, s=64))
    lse = torch.zeros(2, 4, 64)
    args = {"flash_fwd": (q, k, v, True),
            "flash_dq": (q, k, v, q, lse, q, True),
            "flash_dkv": (q, k, v, q, lse, lse, True),
            "flash_fwd_tri": (q, k, v),
            "flash_dq_tri": (q, k, v, q, lse, q),
            "flash_dkv_tri": (q, k, v, q, lse, lse),
            "flash_fwd_streamed": (q, k, v, False),
            "flash_dq_streamed": (q, k, v, q, lse, q, False),
            "flash_dkv_streamed": (q, k, v, q, lse, lse, False)}[wrapper]
    with pytest.raises(ValueError):
        getattr(fa_torch, wrapper)(*args, 0.125)
    assert fa_torch.LAUNCHES[wrapper] == 0
