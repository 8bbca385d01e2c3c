"""The f32 flash routes' 3xTF32 arithmetic, emulated on the CPU against the
reference.

On the card the f32 flash forward and backward (route ``"tf32x3"``) run
every product on the tensor cores in 3xTF32 (``csrc/tf32.h``): each f32
operand is split into its TF32 high part (the f32 bits masked to TF32's
10 mantissa bits) and the TF32 cut of the rest, and ``lo·hi + hi·lo +
hi·hi`` is summed in f32 (``lo·lo`` dropped).  The products that take an
accumulator as their A operand (``P·V``, ``Pᵀ·dO``, ``dSᵀ·Q``, ``dS·K``)
read it in key order: k position ``t`` of each 8 is the accumulator's
column ``2t`` and ``t + 4`` its column ``2t + 1``, and the B operand's
rows are read in the same order.  A CUDA kernel cannot run here, so this
file repeats that arithmetic in torch (the forward with the kernel's key
tiles, its two groups of warps and their online softmax in the log2
domain) and holds it, on seeded
numpy inputs, to the reference's ``chunked_attention`` and its
``jax.vjp`` at ``chip_smoke.py``'s f32 tolerances: the output 2e-5 max
abs (``ATTN_TOL``), the lse 1e-4 (``LSE_TOL``), dq, dk and dv 1e-4
relative L2 (``BWD_TOL``), at the four pairs of head dims with causal,
window and softcap cases.  The port's plain versions stay exact f32; the
emulation lives here.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import chunked_attention as jchunked
from repro_torch.kernels import flash_attention as fa

ATTN_TOL = 2e-5  # max abs, f32 forward (chip_smoke.ATTN_TOL)
LSE_TOL = 1e-4  # max abs (chip_smoke.LSE_TOL)
BWD_TOL = 1e-4  # relative L2 (chip_smoke.BWD_TOL)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# (B, T, H, Kv, dh, dv, Tk, options)
CASES = {
    "dh64_causal_ragged": (2, 67, 4, 2, 64, 64, 67, dict(causal=True)),
    "dh128_softcap_full_tq_lt_tk": (1, 40, 4, 2, 128, 128, 57,
                                    dict(causal=False, softcap=5.0)),
    "dh256_window": (1, 70, 2, 1, 256, 256, 70, dict(causal=True, window=16)),
    "mla_192_128_causal": (1, 40, 4, 4, 192, 128, 40,
                           dict(causal=True, scale=1 / math.sqrt(192))),
    "dh64_softcap_window": (1, 50, 4, 1, 64, 64, 50,
                            dict(causal=True, softcap=3.0, window=9)),
}


def _inputs(case):
    B, T, H, Kv, dh, dv, Tk, kw = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 32)
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (draw(B, T, H, dh), draw(B, Tk, Kv, dh), draw(B, Tk, Kv, dv),
            draw(B, T, H, dv)), kw


def _reference(q, k, v, do, kw):
    """The reference's output and ``jax.vjp`` gradients, and the lse of its
    scores in f64."""
    fn = lambda q_, k_, v_: jchunked(  # noqa: E731
        q_, k_, v_, causal=kw["causal"], window=kw.get("window"),
        attn_softcap=kw.get("softcap"), scale=kw.get("scale"), q_chunk=32,
        kv_chunk=32)
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    B, T, H, dh = q.shape
    rep = H // k.shape[2]
    scale = kw.get("scale") or 1 / math.sqrt(dh)
    s = np.einsum("bqhd,bchd->bhqc", q.astype(np.float64),
                  np.repeat(k, rep, axis=2).astype(np.float64)) * scale
    if kw.get("softcap"):
        s = kw["softcap"] * np.tanh(s / kw["softcap"])
    live = fa.live_mask(T, k.shape[1], kw["causal"], kw.get("window"), "cpu").numpy()
    s = np.where(live, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    lse = np.log(np.exp(s - mx).sum(-1)) + mx[..., 0]
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))], lse


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# -- the emulated arithmetic -------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) cut to TF32: its bits masked to 10 mantissa bits."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def split(x: torch.Tensor):
    """x = hi + lo + what 3xTF32 drops: hi cut to TF32, lo the rest cut so."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in 3xTF32: three TF32 products (each exact in f32), lo·hi +
    hi·lo first, then hi·hi, summed in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def key_order(n: int) -> torch.Tensor:
    """The order in which the products that take an accumulator as A walk
    ``n`` (a multiple of 8) positions: within each 8, k position t is
    column 2t and t + 4 is 2t + 1."""
    return (torch.arange(n).reshape(-1, 8)[:, [0, 2, 4, 6, 1, 3, 5, 7]]).reshape(-1)


def mm3_keyed(a: torch.Tensor, b: torch.Tensor, product=mm3) -> torch.Tensor:
    """``a @ b`` in 3xTF32 (``product``) over k in key order (k padded to 8
    with zeros)."""
    k = a.shape[-1]
    pad = -k % 8
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    perm = key_order(k + pad)
    return product(a[..., perm], b[..., perm, :])


def _grouped(q, k, v):
    """q (B, Kv, rep, T, dh), k and v (B, Kv, 1, Tk, d)."""
    B, T, H, dh = q.shape
    Kv = k.shape[2]
    return (q.reshape(B, T, Kv, H // Kv, dh).permute(0, 2, 3, 1, 4),
            k.permute(0, 2, 1, 3)[:, :, None], v.permute(0, 2, 1, 3)[:, :, None])


def forward_tf32x3(q, k, v, *, causal=True, scale=None, softcap=None, window=None,
                   product=mm3):
    """The f32 forward kernel's arithmetic: per K/V tile of
    ``F32_BLOCK_K[dh]`` keys, split between two groups of warps that each
    keep their own softmax state over their half: S = Q·Kᵀ
    in 3xTF32 (``product``), the softcap and mask, the online softmax in
    the log2 domain, O = O·c + P·V in 3xTF32 with P in key order; then the
    second group's state folded into the first's, o = O / l and lse = (m +
    log2 l)·ln 2."""
    B, T, H, dh = q.shape
    Tk, dv = k.shape[1], v.shape[3]
    scale = scale if scale is not None else 1 / math.sqrt(dh)
    bk = fa.F32_BLOCK_K[dh]
    groups = 2  # of warps (csrc/flash_attention.cu, f32_dispatch)
    n = -(-Tk // bk) * bk
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, n - Tk))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n - Tk))
    qg, kg, vg = _grouped(q, kp, vp)
    live = torch.nn.functional.pad(fa.live_mask(T, Tk, causal, window, "cpu"),
                                   (0, n - Tk))
    states = []
    for grp in range(groups):
        m = torch.full(qg.shape[:-1], -math.inf)
        l = torch.zeros(qg.shape[:-1])
        o = torch.zeros(*qg.shape[:-1], dv)
        for k0 in range(grp * bk // groups, n, bk):
            keys = slice(k0, k0 + bk // groups)
            s = product(qg, kg[..., keys, :].transpose(-1, -2))
            if softcap is not None:
                x = softcap * LOG2E * torch.tanh(s * (scale / softcap))
            else:
                x = s * (scale * LOG2E)
            x = x.masked_fill(~live[:, keys], -math.inf)
            mn = torch.maximum(m, x.amax(-1))
            z = torch.where(mn == -math.inf, torch.zeros(()), mn)
            c = torch.exp2(m - z)
            p = torch.exp2(x - z[..., None])
            l = l * c + p.sum(-1)
            o = o * c[..., None] + mm3_keyed(p, vg[..., keys, :], product)
            m = mn
        states.append((m, l, o))
    m, l, o = states[0]
    for mb, lb, ob in states[1:]:  # the second group folded into the first
        mn = torch.maximum(m, mb)
        z = torch.where(mn == -math.inf, torch.zeros(()), mn)
        ca, cb = torch.exp2(m - z), torch.exp2(mb - z)
        l = l * ca + lb * cb
        o = o * ca[..., None] + ob * cb[..., None]
        m = mn
    out = o / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, (m + torch.log2(l)) * LN2, torch.full((), math.inf))
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, dv), lse.reshape(B, H, T)


def backward_tf32x3(q, k, v, o, do, lse, *, causal=True, scale=None, softcap=None,
                    window=None):
    """The f32 backward kernels' arithmetic: S = Q·Kᵀ and dP = dO·Vᵀ in
    3xTF32, P = exp2(y·log2 e - lse·log2 e), dS = P (dP - D) (times 1 -
    tanh² under a softcap), D = rowsum(dO·O); dV = Pᵀ·dO, dK = dSᵀ·Q·scale
    and dQ = dS·K·scale in 3xTF32 with their A operand in key order; dk
    and dv summed over each kv head's query heads in head order."""
    B, T, H, dh = q.shape
    Tk, Kv, dv = k.shape[1], k.shape[2], v.shape[3]
    rep = H // Kv
    scale = scale if scale is not None else 1 / math.sqrt(dh)
    qg, kg, vg = _grouped(q, k, v)
    gg = _grouped(do, k, v)[0]
    og = _grouped(o, k, v)[0]
    s = mm3(qg, kg.transpose(-1, -2))
    t = None
    if softcap is not None:
        t = torch.tanh(s * (scale / softcap))
        x = t * (softcap * LOG2E)
    else:
        x = s * (scale * LOG2E)
    lse2 = lse.reshape(B, Kv, rep, T, 1) * LOG2E
    live = fa.live_mask(T, Tk, causal, window, "cpu")
    p = torch.where(live, torch.exp2(x - lse2), torch.zeros(()))
    dp = mm3(gg, vg.transpose(-1, -2))
    delta = (gg * og).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    if t is not None:
        ds = ds * (1 - t * t)
    dq = mm3_keyed(ds, kg) * scale
    dk_h = mm3_keyed(ds.transpose(-1, -2), qg) * scale  # (B, Kv, rep, Tk, dh)
    dv_h = mm3_keyed(p.transpose(-1, -2), gg)
    dk, dv_ = dk_h[:, :, 0], dv_h[:, :, 0]
    for r in range(1, rep):  # the reduce kernel's head order
        dk, dv_ = dk + dk_h[:, :, r], dv_ + dv_h[:, :, r]
    return (dq.permute(0, 3, 1, 2, 4).reshape(B, T, H, dh), dk.permute(0, 2, 1, 3),
            dv_.permute(0, 2, 1, 3))


# -- the tests ----------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_tf32x3_matches_reference(case):
    (q, k, v, do), kw = _inputs(case)
    out_ref, _, lse_ref = _reference(q, k, v, do, kw)
    out, lse = forward_tf32x3(*map(torch.from_numpy, (q, k, v)), **kw)
    err = float(np.abs(out.numpy() - out_ref).max())
    lse_err = float(np.abs(lse.numpy() - lse_ref).max())
    assert err <= ATTN_TOL, err
    assert lse_err <= LSE_TOL, lse_err
    assert err > 0  # the splits are really there


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_tf32x3_matches_jax_vjp(case):
    """The five products of the backward (S, dP, dV, dK, dQ; the dq pass
    recomputes S and dP as Sᵀ and dPᵀ are made for dk/dv) from the
    emulated forward's o and lse, as the card runs them."""
    (q, k, v, do), kw = _inputs(case)
    _, grads_ref, _ = _reference(q, k, v, do, kw)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = forward_tf32x3(tq, tk, tv, **kw)
    grads = backward_tf32x3(tq, tk, tv, o, tdo, lse, **kw)
    for name, g, r in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert g.shape == r.shape, name
        assert _rel(g, r) <= BWD_TOL, (name, _rel(g, r))


def test_one_tf32_product_would_not_hold_the_tolerance():
    """Why three products: the forward with one TF32 product (hi·hi) in
    place of three misses the f32 forward's 2e-5, which 3xTF32 holds."""
    (q, k, v, do), kw = _inputs("dh128_softcap_full_tq_lt_tk")
    out_ref = _reference(q, k, v, do, kw)[0]
    one, _ = forward_tf32x3(*map(torch.from_numpy, (q, k, v)), **kw,
                            product=lambda a, b: tf32(a) @ tf32(b))
    assert float(np.abs(one.numpy() - out_ref).max()) > ATTN_TOL


def _mma_m16n8k8(a_frags, b_frags):
    """One ``mma.sync.m16n8k8.row.col`` from its 32 lanes' fragments (lane
    = 4 g + t): A elements (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), B
    elements (k t, n g), (k t + 4, n g); returns each lane's D elements
    (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)."""
    A = np.zeros((16, 8))
    Bm = np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_frags[lane]
        Bm[t, g], Bm[t + 4, g] = b_frags[lane]
    D = A @ Bm
    return [(D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1])
            for g, t in (divmod(lane, 4) for lane in range(32))]


def test_accumulator_is_the_a_fragment_in_key_order():
    """The kernels' register path, lane by lane: an m16n8 accumulator of P
    (16 rows x 8 keys) taken as the A fragment (d0, d2, d1, d3) (tf32.h
    ``acc_as_a``), and V's B fragment read from rows 2t and 2t + 1 (tf32.h
    ``mma3_pairs``), give exactly P·V: no shuffle is needed."""
    rng = np.random.default_rng(7)
    P = rng.integers(-8, 8, (16, 8)).astype(np.float64)
    V = rng.integers(-8, 8, (8, 8)).astype(np.float64)
    acc = [(P[g, 2 * t], P[g, 2 * t + 1], P[g + 8, 2 * t], P[g + 8, 2 * t + 1])
           for g, t in (divmod(lane, 4) for lane in range(32))]
    a = [(d[0], d[2], d[1], d[3]) for d in acc]
    b = [(V[2 * t, g], V[2 * t + 1, g]) for g, t in (divmod(lane, 4)
                                                     for lane in range(32))]
    want = P @ V
    got = _mma_m16n8k8(a, b)
    for lane, d in enumerate(got):
        g, t = divmod(lane, 4)
        assert d == (want[g, 2 * t], want[g, 2 * t + 1], want[g + 8, 2 * t],
                     want[g + 8, 2 * t + 1])
