"""Torch models of how the redesigned kernels compute, held bit for bit to
the plain versions they must equal: the power-law V2C quantizer read from
a table of reconstruction levels (K6's ``qdq_staged``) against
``quantizer.power_qdq``, the uniform one with its constants divided once
(K4's) against ``quantizer.uniform_qdq``, the flooding loop over a
compressed check state (K4, ``csrc/fused_flooding.cu``) against
``fused._plain_flooding``, the layered loop over a compressed check state
(K1, ``csrc/fused_layered.cu``) against ``fused._plain_layered``, and the
row update from sign bits and picked c2v (K5, ``csrc/qc_cn.cu``) against
``qc_rowcol._cn_row_plain``. The CUDA kernels themselves run only on the
card (``tests_gpu/``); these tests check on the CPU that their
restructured arithmetic gives the same bits. No JAX is needed: the
references are the port's plain versions, which the other test files hold
to ``ldpc_tpu``."""

import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.decode import engine, fused, qc_rowcol
from ldpc_tpu_torch.quantizer import QDQ_SIGN_TINY, power_qdq, uniform_qdq
from torch_port_helpers import SMALL_KINDS, channel_llr, make_base

f32 = torch.float32


def same_bits(a, b):
    """Equal bit patterns, NaN where the other is NaN."""
    assert a.dtype == b.dtype and a.shape == b.shape
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    assert torch.equal(nan_a, nan_b)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    assert torch.equal(a[~nan_a].view(ints), b[~nan_b].view(ints))


# ---- K6: the power-law quantizer from a level table

def table_power_qdq(x, C, gamma, levels):
    """K6's ``qdq_staged`` for the power law, op for op: the M + 1 levels
    ``C * powf(i / M, gamma)``, then one ``powf(r, 1 / gamma)``, the index
    clamp and the two corrections read from the table. Both ``powf`` are
    skipped when their exponent is 1, as the kernel does."""
    x = x.to(f32)
    C = torch.tensor(C, dtype=f32)
    gamma = torch.tensor(gamma, dtype=f32)
    M = torch.tensor(float(levels - 1), dtype=f32)
    m = levels - 1
    ratio = torch.div(torch.arange(levels, dtype=f32), M)
    lvl = C * (ratio if gamma.item() == 1.0 else torch.pow(ratio, gamma))
    inv_gamma = torch.div(torch.tensor(1.0), gamma)
    mag = x.abs()
    r = torch.fmin(torch.fmax(torch.div(mag, C), torch.tensor(0.0)),
                   torch.tensor(1.0))
    p = r if inv_gamma.item() == 1.0 else torch.pow(r, inv_gamma)
    idx = torch.fmin(torch.fmax(torch.floor(M * p), torch.tensor(0.0)), M)
    i = torch.nan_to_num(idx).to(torch.int64)
    up = lvl[torch.clamp(i + 1, max=m)]
    i = torch.where((i < m) & (mag >= up), i + 1, i)
    i = torch.where(mag < lvl[i], torch.clamp(i - 1, min=0), i)
    snapped = lvl[i]
    snapped = torch.where(snapped < QDQ_SIGN_TINY,
                          torch.tensor(QDQ_SIGN_TINY, dtype=f32), snapped)
    out = torch.where(x < 0, -snapped, snapped)
    return torch.where(torch.isnan(mag), mag, out)


def _grid(C, gamma, levels):
    """float32 magnitudes in [0, 1.1 C], the levels and their neighbours,
    both signs, +-0 and NaN."""
    C32 = np.float32(C)
    dense = np.linspace(0.0, 1.1 * C, 20001, dtype=np.float32)
    lv = (C32 * np.power(np.arange(levels, dtype=np.float32) /
                         np.float32(levels - 1), np.float32(gamma))
          ).astype(np.float32)
    near = np.concatenate([lv, np.nextafter(lv, np.float32(np.inf)),
                           np.nextafter(lv, np.float32(-np.inf))])
    mags = np.concatenate([dense, near, [0.0, np.float32(1e-30),
                                         np.float32(np.inf)]])
    mags = mags[mags >= 0].astype(np.float32)
    vals = np.concatenate([mags, -mags, [np.float32(-0.0), np.nan]])
    return torch.from_numpy(vals.astype(np.float32))


ZOO_V2C = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))  # zoo/worcq_bc3_qc9472
ZOO_CN = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))


@pytest.mark.parametrize("C,gamma,levels",
                         [(C, g, 128) for C, g in ZOO_V2C] +
                         [(C, g, lv) for C, g in ZOO_CN for lv in (4, 128)])
def test_table_power_qdq_equals_power_qdq(C, gamma, levels):
    """The zoo's V2C ladders (bv = 8, every t) and its CN ladders as power
    laws, on every value of the grid."""
    x = _grid(C, gamma, levels)
    want = power_qdq(x, torch.tensor(C, dtype=f32),
                     torch.tensor(gamma, dtype=f32), levels)
    same_bits(table_power_qdq(x, C, gamma, levels), want)


def staged_uniform_qdq(x, C, levels):
    """common.cuh's ``qdq_uniform`` (K4's V2C quantizer), op for op: the
    constants ``M / C`` and ``C / M`` divided once, C's ``fminf`` /
    ``fmaxf`` (which drop a NaN operand, hence the explicit NaN return)
    for the clamps, the two index corrections and the sign floor."""
    x = x.to(f32)
    C = torch.tensor(C, dtype=f32)
    M = torch.tensor(float(levels - 1), dtype=f32)
    scale, step = torch.div(M, C), torch.div(C, M)
    zero = torch.tensor(0.0)
    mag = x.abs()
    idx = torch.fmin(torch.fmax(torch.floor(mag * scale), zero), M)
    up = torch.fmin(idx + 1.0, M) * step
    idx = torch.where((mag >= up) & (idx < M), idx + 1.0, idx)
    down = idx * step
    idx = torch.where(mag < down, torch.fmax(idx - 1.0, zero), idx)
    snapped = idx * step
    snapped = torch.where(snapped < QDQ_SIGN_TINY,
                          torch.tensor(QDQ_SIGN_TINY, dtype=f32), snapped)
    out = torch.where(x < 0, -snapped, snapped)
    return torch.where(torch.isnan(mag), mag, out)


@pytest.mark.parametrize("C,levels", [(C, 128) for C, _ in ZOO_V2C] +
                         [(2.6474, 4), (5.3767, 16)])
def test_staged_uniform_qdq_equals_uniform_qdq(C, levels):
    """The zoo's uniform V2C ladder (bv = 8, every t) and two short ladders,
    on every value of the grid, ±0.0 and NaN included."""
    x = _grid(C, 1.0, levels)
    want = uniform_qdq(x, torch.tensor(C, dtype=f32), levels)
    same_bits(staged_uniform_qdq(x, C, levels), want)


# ---- K4: the flooding loop over a compressed check state

def compressed_flooding(llr, tabs, qc, spec, T, closed):
    """K4's loop, op for op, in torch: per check only (min1, min2, first
    argmin, parity of the negative count, one negative bit per edge), per
    variable the column sum in the storage type; every c2v recomputed
    from its check's state where it is read (the VN column sum at t, the
    CN extrinsic at t + 1). On a row whose blocks share (beta, alpha) at t
    the check keeps instead the four c2v it can send, c2v(+-1, min1 or
    min2), and each edge picks one. Returns (posterior [B, n],
    success [B])."""
    dtype = llr.dtype
    B, L, nb = llr.shape[0], qc.lift, qc.nb
    lcol = llr.view(B, nb, L).transpose(0, 1)        # [nb, B, L], var-aligned
    cols = [int(c) for c in qc.block_col]
    shifts = [int(s) for s in qc.block_shift]
    row_of = {int(b): i for i, blocks in enumerate(qc.row_blocks)
              for b in blocks}
    pos = {int(b): k for blocks in qc.row_blocks
           for k, b in enumerate(blocks)}
    beta, alpha = tabs["beta"], tabs["alpha"]

    def rnd(v):
        return v.to(dtype).to(f32)

    def transform(t, b, loo_neg, loo_mag):
        qdq = engine._qdq_at(spec, tabs, t, False, closed)
        return rnd(engine._transform(spec, qdq, beta[t, b], alpha[t, b],
                                     1.0 - 2.0 * loo_neg.to(f32), loo_mag))

    def uniform(t, blocks):
        """The row's blocks share (beta, alpha) at t, bit for bit."""
        idx = torch.as_tensor([int(b) for b in blocks])
        return all(len(torch.unique(w[t, idx].view(torch.int32))) == 1
                   for w in (beta, alpha))

    def c2v(state, k, t, b):
        """The stored c2v of edge k of a row at iteration t (check-aligned)."""
        min1, min2, argm, par, neg, slots = state
        loo_neg = par ^ neg[k]
        if slots is not None:  # picked from the check's four c2v
            p1, n1, p2, n2 = slots
            one = torch.where(loo_neg == 1, n1, p1)
            two = torch.where(loo_neg == 1, n2, p2)
            return torch.where(argm == k, two, one)
        return transform(t, b, loo_neg, torch.where(argm == k, min2, min1))

    states, colsum, posts = [None] * qc.mb, None, [None] * nb
    for t in range(T):
        vqdq = engine._qdq_at(spec, tabs, t - 1, True, closed) if t else None
        for i, blocks in enumerate(qc.row_blocks):
            xs = []
            for k, b in enumerate(blocks):
                x = torch.roll(lcol[cols[b]], -shifts[b], -1).to(f32)
                if t:
                    cs = torch.roll(colsum[cols[b]], -shifts[b], -1).to(f32)
                    ext = rnd(cs - c2v(states[i], k, t - 1, b))
                    nv = (rnd(x + ext) if spec.alpha_in_cn
                          else x + alpha[t - 1, b] * ext)
                    x = rnd(vqdq(nv) if vqdq is not None else nv)
                xs.append(x)
            min1, min2, argm, neg_cnt = engine._min_tree(xs)
            slots = None
            if uniform(t, blocks):
                b0, one = int(blocks[0]), torch.ones_like(argm)
                slots = [transform(t, b0, sign * one, mag)
                         for mag in (min1, min2) for sign in (0, 1)]
            states[i] = (min1, min2, argm, neg_cnt & 1,
                         [(x < 0).to(torch.int32) for x in xs], slots)
        sums = []
        for j, blocks in enumerate(qc.col_blocks):
            s = None
            for k, b in enumerate(blocks):
                b = int(b)
                ca = torch.roll(c2v(states[row_of[b]], pos[b], t, b),
                                shifts[b], -1)
                s = ca if k == 0 else rnd(s + ca)
            sums.append(s.to(dtype))
            if t == T - 1:
                post = rnd(lcol[j].to(f32) + s)
                vq = engine._qdq_at(spec, tabs, t, True, closed)
                posts[j] = (vq(post) if vq is not None else post).to(dtype)
        colsum = torch.stack(sums)
    post = torch.stack(posts)                            # [nb, B, L]
    return (post.transpose(0, 1).reshape(B, qc.n),
            engine._syndrome_ok(post, qc))


T = 5


def _hard_llr(n):
    """Channel LLRs with NaN, -0.0 and many ties (values on a 0.5 grid)."""
    llr = np.round(2.0 * channel_llr(29, n, 2.0, seed=13)) / 2.0
    llr[0, 3] = llr[4, 17] = llr[9, 40] = np.nan
    llr[1, :8] = -0.0
    llr[2, :] = 1.5                      # every magnitude ties
    return torch.from_numpy(llr.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SMALL_KINDS))
def test_compressed_flooding_equals_plain(name, dtype):
    """All kinds on the 3x8 lift-16 code with a degree-1 row: posterior
    and success bit for bit, NaN where the plain version has NaN."""
    base = make_base(3, 8, 16, seed=0)
    base[2, 1:] = -1  # row 2 keeps one block
    code = lt.create_qc_code(base, lift=16, max_iterations=T)
    qc = lt.build_qc_graph(base, 16)
    assert min(len(r) for r in qc.row_blocks) == 1
    dec = lt.make_decoder(code, max_iterations=T, qc=qc, device="cpu",
                          **SMALL_KINDS[name])
    closed = dec.spec.closed_qdq
    tabs = engine._tables(dec.weights, dec.spec, T, qc.num_blocks, "cpu")
    x = _hard_llr(code.n).to(dtype)
    want_post, want_ok = fused._plain_flooding(x, tabs, qc, dec.spec, T,
                                               closed)
    post, ok = compressed_flooding(x, tabs, qc, dec.spec, T, closed)
    same_bits(post, want_post)
    assert torch.equal(ok, want_ok)
    assert torch.isnan(want_post.float()).any()


# ---- the compressed check state shared by the K1 and K5 models

def _rnd(v, dtype):
    return v.to(dtype).to(f32)


def _shares(tabs, t, blocks):
    """The row's blocks share (beta, alpha) at t, bit for bit."""
    idx = torch.as_tensor([int(b) for b in blocks])
    return all(len(torch.unique(w[t, idx].view(torch.int32))) == 1
               for w in (tabs["beta"], tabs["alpha"]))


def _check_state(xs, transform, shared):
    """One check state from a row's float32 v2c ``xs`` (check-aligned):
    (min1, min2, first argmin, parity, one negative bit per edge, and on a
    row that shares (beta, alpha) the four c2v c2v(+-1, min1 or min2),
    each from its own operands). ``transform(k, loo_neg, mag)`` is edge
    k's c2v."""
    min1, min2, argm, neg_cnt = engine._min_tree(xs)
    one = torch.ones_like(argm)
    slots = ([transform(0, neg * one, mag) for mag in (min1, min2)
              for neg in (0, 1)] if shared else None)
    return (min1, min2, argm, neg_cnt & 1,
            [(x < 0).to(torch.int32) for x in xs], slots)


def _edge_c2v(state, k, transform):
    """Edge k's c2v from its check's state: picked from the four where the
    row shares (beta, alpha), else transformed from min1 or min2."""
    min1, min2, argm, par, neg, slots = state
    loo_neg = par ^ neg[k]
    if slots is not None:
        p1, n1, p2, n2 = slots
        one = torch.where(loo_neg == 1, n1, p1)
        two = torch.where(loo_neg == 1, n2, p2)
        return torch.where(argm == k, two, one)
    return transform(k, loo_neg, torch.where(argm == k, min2, min1))


# ---- K1: the layered loop over a compressed check state

def compressed_layered(llr, tabs, qc, spec, T, closed):
    """K1's loop, op for op, in torch: per check only its state
    (:func:`_check_state`; float32 minima, since the layered v2c
    ``llr + alpha * ext`` is not rounded), per variable the column sum in
    the storage type. Row i's pass 1 at t takes back the c2v the row sent
    at t - 1, recomputed from the state of t - 1 with the tables of t - 1
    (nothing at t = 0); pass 2 adds the c2v of t, from the new state and
    the sign bits pass 1 kept. Returns (posterior [B, n], success [B])."""
    dtype = llr.dtype
    B, L, nb = llr.shape[0], qc.lift, qc.nb
    lcol = llr.view(B, nb, L).transpose(0, 1)        # [nb, B, L], var-aligned
    colsum = torch.zeros((nb, B, L), dtype=dtype)
    cols = [int(c) for c in qc.block_col]
    shifts = [int(s) for s in qc.block_shift]
    beta, alpha = tabs["beta"], tabs["alpha"]

    def transform_at(t, blocks):
        qdq = engine._qdq_at(spec, tabs, t, False, closed)
        return lambda k, loo_neg, mag: _rnd(engine._transform(
            spec, qdq, beta[t, blocks[k]], alpha[t, blocks[k]],
            1.0 - 2.0 * loo_neg.to(f32), mag), dtype)

    states = [None] * qc.mb
    for t in range(T):
        for i, blocks in enumerate(qc.row_blocks):
            blocks = [int(b) for b in blocks]
            old = transform_at(t - 1, blocks) if t else None
            xs = []
            for k, b in enumerate(blocks):
                j, s = cols[b], shifts[b]
                ext = torch.roll(colsum[j], -s, -1).to(f32)
                if t:
                    ext = _rnd(ext - _edge_c2v(states[i], k, old), dtype)
                colsum[j] = torch.roll(ext.to(dtype), s, -1)
                x = torch.roll(lcol[j], -s, -1).to(f32)
                xs.append(_rnd(x + ext, dtype) if spec.alpha_in_cn
                          else x + alpha[t, b] * ext)
            new = transform_at(t, blocks)
            states[i] = _check_state(xs, new, _shares(tabs, t, blocks))
            for k, b in enumerate(blocks):
                j, s = cols[b], shifts[b]
                cs = torch.roll(colsum[j], -s, -1).to(f32)
                c2 = _edge_c2v(states[i], k, new)
                colsum[j] = torch.roll((cs + c2).to(dtype), s, -1)
    post = (lcol.to(f32) + colsum.to(f32)).to(dtype)
    vqdq = engine._qdq_at(spec, tabs, T - 1, True, closed)
    if vqdq is not None:
        post = vqdq(post).to(dtype)
    return post.transpose(0, 1).reshape(B, qc.n), engine._syndrome_ok(post,
                                                                      qc)


def _small_decoder(name):
    """The 3x8 lift-16 code whose row 2 keeps one block (an irregular base
    with a degree-1 row), and a decoder of kind ``name`` on the CPU."""
    base = make_base(3, 8, 16, seed=0)
    base[2, 1:] = -1
    code = lt.create_qc_code(base, lift=16, max_iterations=T)
    qc = lt.build_qc_graph(base, 16)
    assert min(len(r) for r in qc.row_blocks) == 1
    return lt.make_decoder(code, max_iterations=T, qc=qc, device="cpu",
                           **SMALL_KINDS[name])


def _weight_cases(dec):
    """The decoder's weights, and for trained kinds also weights whose alpha
    is one value at even iterations: there the rows that share beta share
    (beta, alpha), at odd iterations they do not, so a row's check state
    switches kind from one iteration to the next."""
    cases = [dec.weights]
    if dec.weights.get("alpha") is not None:
        alt = {k: (None if v is None else v.clone())
               for k, v in dec.weights.items()}
        alt["alpha"][::2] = alt["alpha"][::2, :1]
        cases.append(alt)
    return cases


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SMALL_KINDS))
def test_compressed_layered_equals_plain(name, dtype):
    """All kinds on the irregular 3x8 code with a degree-1 row, with rows
    that share (beta, alpha) and rows that do not: posterior and success
    bit for bit, NaN where the plain version has NaN."""
    dec = _small_decoder(name)
    qc, closed = dec.qc, dec.spec.closed_qdq
    x = _hard_llr(dec.code.n).to(dtype)
    for weights in _weight_cases(dec):
        tabs = engine._tables(weights, dec.spec, T, qc.num_blocks, "cpu")
        want_post, want_ok = fused._plain_layered(x, tabs, qc, dec.spec, T,
                                                  closed)
        post, ok = compressed_layered(x, tabs, qc, dec.spec, T, closed)
        same_bits(post, want_post)
        assert torch.equal(ok, want_ok)
        assert torch.isnan(want_post.float()).any()


# ---- K5: the row update from sign bits and picked c2v

def sign_bit_cn_row(v2c, c2v, tabs, qc, spec, row, t):
    """K5, op for op, in torch: each message read once into the min chain
    and one sign bit; where the row shares (beta, alpha) at t the four c2v
    once per (check, frame) and a pick per edge, else the transform per
    edge from min1 or min2; one cast to the storage type."""
    blocks = [int(b) for b in qc.row_blocks[row]]
    shifts = [int(qc.block_shift[b]) for b in blocks]
    qdq = qc_rowcol._kernel_qdq(spec.q_levels, tabs["thr"][t], tabs["qp"][t])

    def transform(k, loo_neg, mag):
        b = blocks[k]
        return engine._transform(spec, qdq, tabs["beta"][t, b],
                                 tabs["alpha"][t, b],
                                 1.0 - 2.0 * loo_neg.to(f32), mag)

    xs = [torch.roll(v2c[b], -s, dims=0).to(f32)
          for b, s in zip(blocks, shifts)]
    state = _check_state(xs, transform, _shares(tabs, t, blocks))
    for k, (b, s) in enumerate(zip(blocks, shifts)):
        out = _edge_c2v(state, k, transform)
        c2v[b] = torch.roll(out.to(c2v.dtype), s, dims=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SMALL_KINDS))
def test_sign_bit_cn_row_equals_plain(name, dtype):
    """Every row of the irregular 3x8 code (one of degree 1), all kinds, at
    the first and the last iteration, with rows that share (beta, alpha)
    and rows that do not, on messages with NaN, -0.0 and ties: every
    output bit for bit."""
    dec = _small_decoder(name)
    qc, spec = dec.qc, dec.spec
    rng = np.random.default_rng(17)
    x = np.round(2.0 * rng.standard_normal((qc.num_blocks, 16, 13))) / 2.0
    x[0, 1, :3] = np.nan
    x[1, 0, :7] = -0.0
    x[3, :, 5] = 1.5                     # ties
    v2c = torch.from_numpy(x.astype(np.float32)).to(dtype)
    for weights in _weight_cases(dec):
        tabs = engine._tables(weights, spec, T, qc.num_blocks, "cpu")
        for t in (0, 1, T - 1):
            got, want = torch.zeros_like(v2c), torch.zeros_like(v2c)
            for i in range(qc.mb):
                sign_bit_cn_row(v2c, got, tabs, qc, spec, i, t)
                qc_rowcol._cn_row_plain(v2c, want, tabs, qc, spec, i, t)
            same_bits(got, want)
