"""The rounding of the bf16 tensor-core flash kernels (csrc/flash_fwd.cu
``flash_fwd_mma_kernel``, csrc/flash_bwd.cu ``flash_bwd_dq_mma_kernel``
and ``flash_bwd_dkv_mma_kernel``), modelled in plain torch on the CPU and
held against the JAX package's ``_flash_fwd``/``_flash_bwd`` (Pallas in
interpret mode, as tests/test_pallas_ops.py runs them) at the card
check's tolerances.

The kernels take bf16 inputs, so every input here is bf16-representable.
The models repeat what the kernels round: the forward sums exact bf16
products in f32, runs the online softmax over 64-key tiles and rounds P
to bf16 before P V (l sums the f32 P); the backward kernels split P and
dS into a bf16 hi part and a bf16 lo part (lo = bf16(x - hi)) and run
each of dS K (dQ), P^T dO and dS^T Q (dK/dV) as two products.  Every
output is rounded once to bf16.  Tolerances are chip_smoke.py's: o within
2e-2 absolute, lse within 1e-4 relative (floored at 1), dq/dk/dv within
rtol 1e-2, atol 1e-3.  The card tests (tests/test_torch_cuda.py) hold the
kernels themselves to the same plain versions."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.ops.pallas import \
    flash_attention as jax_flash
from parameter_server_distributed_tpu_torch.ops import flash_attention as fa

KEY_TILE = 64   # keys per tile of the forward kernel

# (BH, G, S, D): folded GQA shapes; S=200 leaves a ragged last tile in
# every segment, G=1 is MHA
SHAPES = [(2, 4, 256, 64), (2, 2, 256, 128), (2, 3, 200, 64),
          (1, 1, 256, 128)]


def _bf16(rng, *shape):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _round(x)
    return hi, _round(x - hi)


def _block(s: int) -> int:
    return 64 if s % 64 == 0 else 40


def _jax_fwd(q, k, v, s):
    blk = _block(s)
    o, lse = jax_flash._flash_fwd(*map(jnp.asarray, (q, k, v)), blk, blk,
                                  True, s // blk)
    return np.array(o), np.array(lse)


def mma_fwd_model(q, k, v, seg):
    """The forward kernel's arithmetic on f32 tensors holding bf16
    values: (o rounded to bf16, lse f32)."""
    bh, sq, d = q.shape
    groups, scale = sq // seg, 1.0 / math.sqrt(d)
    qf = q.reshape(bh, groups, seg, d)
    rows = torch.arange(seg)[:, None]
    m = torch.full((bh, groups, seg), fa.NEG_INF)
    l = torch.zeros((bh, groups, seg))
    acc = torch.zeros((bh, groups, seg, d))
    for k0 in range(0, seg, KEY_TILE):
        kt, vt = k[:, k0:k0 + KEY_TILE], v[:, k0:k0 + KEY_TILE]
        live = torch.arange(k0, k0 + kt.shape[1])[None, :] <= rows
        s = torch.einsum("bgqd,bkd->bgqk", qf, kt) * scale
        s = s.masked_fill(~live, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]).masked_fill(~live, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bgqk,bkd->bgqd",
                                                    _round(p), vt)
        m = m_new
    l = l.clamp_min(1e-30)
    o = _round(acc / l[..., None]).reshape(bh, sq, d)
    return o, (m + torch.log(l)).reshape(bh, 1, sq)


def _p_ds(q, k, v, o, lse, do, seg):
    """What both backward kernels compute first, in f32 from exact bf16
    products: (q, dO as [BH, G, S, D], P, dS, scale)."""
    bh, sq, d = q.shape
    groups, scale = sq // seg, 1.0 / math.sqrt(d)

    def rows(x):
        return x.reshape(bh, groups, seg, d)

    qf, of, dof = rows(q), rows(o), rows(do)
    mask = torch.ones(seg, seg, dtype=torch.bool).tril()
    s = torch.einsum("bgqd,bkd->bgqk", qf, k) * scale
    p = torch.exp(s - lse.reshape(bh, groups, seg, 1))
    p = p.masked_fill(~mask, 0.0)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bgqd,bkd->bgqk", dof, v) - delta)
    return qf, dof, p, ds, scale


def mma_dkv_model(q, k, v, o, lse, do, seg, split=True):
    """The dK/dV kernel's arithmetic: P^T and dS^T in f32, then each of
    P^T dO and dS^T Q as products on the hi and lo bf16 parts of P and dS
    (``split=False``: one bf16 rounding each).  Returns the f32 sums
    (dk, dv) before the output rounding."""
    qf, dof, p, ds, scale = _p_ds(q, k, v, o, lse, do, seg)
    parts_p = _split(p) if split else (_round(p),)
    parts_ds = _split(ds) if split else (_round(ds),)
    dv = sum(torch.einsum("bgqk,bgqd->bkd", x, dof) for x in parts_p)
    dk = sum(torch.einsum("bgqk,bgqd->bkd", x, qf) for x in parts_ds)
    return dk * scale, dv


def mma_dq_model(q, k, v, o, lse, do, seg, split=True):
    """The dQ kernel's arithmetic: P and dS in f32, then dS K as products
    on the hi and lo bf16 parts of dS (``split=False``: one bf16
    rounding), scaled once at the end.  Returns the f32 dq before the
    output rounding."""
    _, _, _, ds, scale = _p_ds(q, k, v, o, lse, do, seg)
    parts = _split(ds) if split else (_round(ds),)
    dq = sum(torch.einsum("bgqk,bkd->bgqd", x, k) for x in parts)
    return (dq * scale).reshape(q.shape)


@pytest.mark.parametrize("bh,groups,s,d", SHAPES)
def test_forward_model_matches_pallas(bh, groups, s, d):
    rng = np.random.default_rng(bh + groups + s + d)
    q = _bf16(rng, bh, groups * s, d)
    k, v = _bf16(rng, bh, s, d), _bf16(rng, bh, s, d)
    ref_o, ref_lse = _jax_fwd(q, k, v, s)
    o, lse = mma_fwd_model(*map(torch.from_numpy, (q, k, v)), s)
    assert float(np.abs(o.numpy() - ref_o).max()) <= 2e-2
    rel = np.abs(lse.numpy() - ref_lse) / np.maximum(np.abs(ref_lse), 1.0)
    assert float(rel.max()) <= 1e-4


@functools.lru_cache(maxsize=None)
def _bwd_case(bh, groups, s, d):
    """bf16-valued backward inputs (q, k, v, o, lse, dO) and the JAX
    _flash_bwd's (dq, dk, dv) on them, shared by the dQ and dK/dV tests.
    o comes from the JAX forward, rounded to bf16 as the bf16 forward hands
    it to the backward; both sides get the same o and lse."""
    rng = np.random.default_rng(10 * bh + groups + s + d)
    q, g = _bf16(rng, bh, groups * s, d), _bf16(rng, bh, groups * s, d)
    k, v = _bf16(rng, bh, s, d), _bf16(rng, bh, s, d)
    o, lse = _jax_fwd(q, k, v, s)
    o = _round(torch.from_numpy(o)).numpy()
    blk = _block(s)
    ref = jax_flash._flash_bwd(*map(jnp.asarray, (q, k, v, o, lse, g)), blk,
                               blk, True, s // blk)
    return (q, k, v, o, lse, g), tuple(np.asarray(x) for x in ref)


@pytest.mark.parametrize("bh,groups,s,d", SHAPES)
def test_dkv_model_matches_pallas(bh, groups, s, d):
    ins, (_, ref_dk, ref_dv) = _bwd_case(bh, groups, s, d)
    dk, dv = mma_dkv_model(*map(torch.from_numpy, ins), s)
    for name, got, ref in (("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        np.testing.assert_allclose(_round(got).numpy(), ref,
                                   rtol=1e-2, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("bh,groups,s,d", SHAPES)
def test_dq_model_matches_pallas(bh, groups, s, d):
    ins, (ref_dq, _, _) = _bwd_case(bh, groups, s, d)
    dq = mma_dq_model(*map(torch.from_numpy, ins), s)
    np.testing.assert_allclose(_round(dq).numpy(), ref_dq, rtol=1e-2,
                               atol=1e-3)


def test_split_is_closer_than_one_rounding():
    """Before the output rounding, the hi/lo products land far nearer the
    f32 sums than products on one bf16 rounding of P and dS: the split
    is what keeps dq, dk and dv inside the bf16 tolerance at the training
    shape."""
    bh, groups, s, d = 2, 4, 256, 64
    rng = np.random.default_rng(5)
    q, g = _bf16(rng, bh, groups * s, d), _bf16(rng, bh, groups * s, d)
    k, v = _bf16(rng, bh, s, d), _bf16(rng, bh, s, d)
    o, lse = _jax_fwd(q, k, v, s)
    ins = [torch.from_numpy(x) for x in (q, k, v, _round(
        torch.from_numpy(o)).numpy(), lse, g)]
    refs = fa.flash_bwd_reference(*ins[:4], ins[4], ins[5], s)
    split = (mma_dq_model(*ins, s), *mma_dkv_model(*ins, s))
    single = (mma_dq_model(*ins, s, split=False),
              *mma_dkv_model(*ins, s, split=False))
    for name, ref, a, b in zip(("dq", "dk", "dv"), refs, split, single):
        err_split = float((a - ref).abs().max())
        err_single = float((b - ref).abs().max())
        assert err_split * 50 < err_single, name


@pytest.mark.parametrize("scale", [1.0, 1e-3, 30.0])
def test_hi_lo_split_carries_seventeen_bits(scale):
    """hi + lo reproduces x to 2^-17 of itself (hi alone: 2^-9)."""
    rng = np.random.default_rng(int(scale * 1000))
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)
                         * scale)
    hi, lo = _split(x)
    assert bool(((hi + lo - x).abs() <= 2.0 ** -17 * x.abs()).all())
    assert float(((hi - x).abs() / x.abs()).max()) > 2.0 ** -17


def test_misaligned_operand_is_refused():
    """The kernels copy 16 bytes a thread: a view 2 bytes into its
    storage is refused before any launch."""
    base = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    fa._check_aligned(base[8:].view(4, 64))
    with pytest.raises(ValueError, match="aligned"):
        fa._check_aligned(base[8:].view(4, 64), base[1:257].view(4, 64))
