"""The row and column CUDA kernels K5 (``csrc/qc_cn.cu``) and K6
(``csrc/qc_vn.cu``) against their plain PyTorch versions, on the card (the
kernels have no CPU mode). Run on a machine with an NVIDIA GPU:

    python -m pytest tests_gpu -m cuda -q

These tests import no JAX. The kernels are built with -fmad=false and
IEEE division, so single launches and the whole decode equal their plain
versions bit for bit in f32 and bf16 (NaN where the plain version has
NaN)."""

import ctypes

import numpy as np
import pytest
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.decode import engine, qc_engine, qc_rowcol

pytestmark = pytest.mark.cuda

T = 5
KINDS = {
    "ms": dict(kind="ms", factor=0.7),
    "rcq_bc3_bv8": dict(kind="rcq", bc=3, bv=8),
    "nms_t2": dict(kind="nms", sharing_type=2, init="nms", seed=1),
    "oms_t2": dict(kind="oms", sharing_type=2, seed=5),
    "wrcq_t2": dict(kind="wrcq", bc=3, sharing_type=2, init="nms", seed=6),
    "orcq_t2": dict(kind="orcq", bc=3, sharing_type=2, seed=7),
    "rcq_bc5_closed": dict(kind="rcq", bc=5, bv=8, closed_qdq=True),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _decoder(**kw):
    rng = np.random.default_rng(3)
    base = rng.integers(0, 16, size=(3, 7))
    base[rng.random((3, 7)) < 0.15] = -1
    base[:, 0] = np.maximum(base[:, 0], 0)  # every row keeps a block
    base[0] = np.maximum(base[0], 0)        # every column keeps a block
    code = lt.create_qc_code(base, lift=16, max_iterations=T)
    return lt.make_decoder(code, max_iterations=T,
                           qc=lt.build_qc_graph(base, 16), **kw)


def _close(got, want, dtype):
    """Bit for bit, NaN where the plain version has NaN."""
    assert got.dtype == want.dtype == dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got[~nan].view(ints), want[~nan].view(ints))


@pytest.mark.parametrize("B", [160, 150], ids=["B160", "B150"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(KINDS))
def test_kernels_match_plain(card, name, dtype, B):
    """Every row through K5 and every column through K6 at the first and
    the last iteration: B=160 (a partial thread block; 8-byte accesses)
    and B=150 (in bf16 not a multiple of the kernels' 4 frames per thread:
    frame by frame), with NaN, +-0 and ties among K5's and K6's inputs;
    irregular rows, which in the trained kinds do not share (beta,
    alpha)."""
    dec = _decoder(**KINDS[name])
    qc, spec = dec.qc, dec.spec
    gen = torch.Generator(device=card).manual_seed(2)
    llr = lt.awgn_llr(gen, torch.zeros((B, dec.code.n), device=card), 2.5)
    llr_T = qc_engine._storage(llr, qc, dtype)
    tabs = engine._tables(dec.weights, spec, T, qc.num_blocks, card)
    v2c = llr_T.index_select(0, qc_engine._graph_tables(qc, card)
                             ["block_col"])
    v2c[0, 1, :3] = float("nan")
    v2c[1, 0, :7] = -0.0
    v2c[2, :, 5] = 1.5
    c2v = (3.0 * torch.randn(v2c.shape, generator=gen, device=card)
           ).to(dtype)
    c2v[0, 0, :4] = float("nan")
    c2v[1, 2, :9] = -0.0
    c2v[2, 3, :] = 1.5
    for t in (0, T - 1):
        before = (qc_rowcol.CN_LAUNCHES, qc_rowcol.VN_LAUNCHES)
        got, want = torch.zeros_like(v2c), torch.zeros_like(v2c)
        for i in range(qc.mb):
            qc_rowcol.cn_row(v2c, got, tabs, qc, spec, i, t)
            qc_rowcol._cn_row_plain(v2c, want, tabs, qc, spec, i, t)
        _close(got, want, dtype)
        gv, wv = torch.zeros_like(v2c), torch.zeros_like(v2c)
        gp, wp = torch.zeros_like(llr_T), torch.zeros_like(llr_T)
        for j in range(qc.nb):
            qc_rowcol.vn_col(c2v, llr_T, gv, gp, tabs, qc, spec, j, t)
            qc_rowcol._vn_col_plain(c2v, llr_T, wv, wp, tabs, qc, spec, j, t)
        torch.cuda.synchronize()
        _close(gv, wv, dtype)
        _close(gp, wp, dtype)
        # one launch per row and per column; the plain versions count none
        assert (qc_rowcol.CN_LAUNCHES, qc_rowcol.VN_LAUNCHES) == (
            before[0] + qc.mb, before[1] + qc.nb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_zoo_column_matches_plain(card, dtype):
    """K6 on every column of the zoo decoder (dv = 5, the bv = 8 ladder
    through the power law at gamma = 1) at t = 0 and T-1, at B = 4096 (8-
    byte accesses) and B = 1029 (frame by frame), bit for bit."""
    dec = lt.load_pretrained("worcq_bc3_qc9472")
    qc, spec = dec.qc, dec.spec
    Tz = dec.max_iterations
    tabs = engine._tables(dec.weights, spec, Tz, qc.num_blocks, card)
    gen = torch.Generator(device=card).manual_seed(7)
    for B in (4096, 1029):
        llr = lt.awgn_llr(gen, torch.zeros((B, dec.code.n), device=card),
                          6.25)
        llr_T = qc_engine._storage(llr, qc, dtype)
        c2v = (2.0 * torch.randn((qc.num_blocks, qc.lift, B), generator=gen,
                                 device=card)).to(dtype)
        for t in (0, Tz - 1):
            gv, wv = torch.zeros_like(c2v), torch.zeros_like(c2v)
            gp, wp = torch.zeros_like(llr_T), torch.zeros_like(llr_T)
            for j in range(qc.nb):
                qc_rowcol.vn_col(c2v, llr_T, gv, gp, tabs, qc, spec, j, t)
                qc_rowcol._vn_col_plain(c2v, llr_T, wv, wp, tabs, qc, spec,
                                        j, t)
            torch.cuda.synchronize()
            _close(gv, wv, dtype)
            _close(gp, wp, dtype)


def test_powf_one_is_identity_on_unit_interval(card):
    """K6's gamma == 1 shortcut (common.cuh qdq_staged) skips powf(r, 1/gamma)
    when 1/gamma == 1: that is exact only if powf(r, 1.0f) == r, bit for
    bit, for every float32 r in [-0, 1] (about 1.07e9 values, all of them
    checked by the library's kernel)."""
    from ldpc_tpu_torch.decode._build import load_library

    count = torch.zeros(1, dtype=torch.int32, device=card)
    err = load_library().ldpc_powf_one_mismatches(
        ctypes.c_void_p(count.data_ptr()), 1.0,
        ctypes.c_void_p(torch.cuda.current_stream(card).cuda_stream))
    torch.cuda.synchronize()
    assert err == 0
    assert count.item() == 0


def test_occupancy_entry_points(card):
    """The library reports resident CTAs per SM for K5 and K6 at the zoo's
    degrees (dc = 37, dv = 5), as chip_smoke prints them."""
    from ldpc_tpu_torch.decode._build import load_library

    lib = load_library()
    for bf16 in (0, 1):
        assert lib.ldpc_qc_cn_occupancy(37, bf16, 4, 4) >= 1
        assert lib.ldpc_qc_cn_occupancy(70, bf16, 0, 0) >= 1
        assert lib.ldpc_qc_vn_occupancy(5, 128, bf16) >= 1
        assert lib.ldpc_qc_vn_occupancy(11, 128, bf16) >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_matches_plain(card, dtype):
    """The whole decode on the zoo decoder (T=4, check_every 2) against
    its plain driver on the card; an empty batch is a valid call."""
    dec = lt.load_pretrained("worcq_bc3_qc9472", max_iterations=4)
    gen = torch.Generator(device=card).manual_seed(4)
    llr = lt.awgn_llr(gen, torch.zeros((96, dec.code.n), device=card), 6.0)
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=4, check_every=2,
                dtype=dtype, batch_tile=32)
    out = lt.qc_pallas_decode_batch(llr, dec.weights, **args)
    ref = qc_rowcol._qc_pallas_plain(llr, dec.weights, **args)
    torch.cuda.synchronize()
    assert torch.equal(out.iterations, ref.iterations)
    assert torch.equal(out.bits, ref.bits)
    assert torch.equal(out.success, ref.success)
    _close(out.posterior, ref.posterior, dtype)
    empty = lt.qc_pallas_decode_batch(llr[:0], dec.weights, **args)
    assert empty.bits.shape == (0, dec.code.n)


def test_steady_state_call_copies_nothing_from_host(card):
    """After the first call has built the device tables, a decode through
    K5/K6 makes no host-to-device copy."""
    from torch.profiler import ProfilerActivity, profile

    dec = lt.load_pretrained("worcq_bc3_qc9472")
    gen = torch.Generator(device=card).manual_seed(5)
    llr = lt.awgn_llr(gen, torch.zeros((256, dec.code.n), device=card), 6.5)
    args = dict(qc=dec.qc, spec=dec.spec, max_iterations=10,
                dtype=torch.bfloat16)
    lt.qc_pallas_decode_batch(llr, dec.weights, **args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lt.qc_pallas_decode_batch(llr, dec.weights, **args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    for kernel in ("qc_cn_kernel", "qc_vn_kernel"):
        assert any(kernel in n for n in names), \
            "the profiler saw no kernel; it cannot show copies either"
    assert not [n for n in names if "HtoD" in n]


def _row_outputs(dec, v2c, weights, t):
    """Every row of ``dec`` through K5 and through its plain version at t
    -> (kernel's c2v, plain c2v)."""
    qc, spec = dec.qc, dec.spec
    tabs = engine._tables(weights, spec, dec.max_iterations, qc.num_blocks,
                          v2c.device)
    got, want = torch.zeros_like(v2c), torch.zeros_like(v2c)
    for i in range(qc.mb):
        qc_rowcol.cn_row(v2c, got, tabs, qc, spec, i, t)
        qc_rowcol._cn_row_plain(v2c, want, tabs, qc, spec, i, t)
    torch.cuda.synchronize()
    return got, want


def _messages(gen, shape, dtype, card):
    v2c = torch.round(2.0 * torch.randn(shape, generator=gen, device=card)
                      ) / 2.0                  # ties on a 0.5 grid
    v2c[0, 1, :3] = float("nan")
    v2c[1, 0, :7] = -0.0
    return v2c.to(dtype)


@pytest.mark.parametrize("B", [160, 150], ids=["B160", "B150"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["nms_t2", "oms_t2", "wrcq_t2", "orcq_t2"])
def test_shared_and_per_block_rows_match_plain(card, name, dtype, B):
    """K5 on rows whose blocks share (beta, alpha) (four c2v per check,
    one picked per edge) and rows that do not (the transform per edge):
    alpha is made one value at even iterations, so the same rows take
    both paths; bit for bit at B=160 and B=150."""
    dec = _decoder(**KINDS[name])
    alt = {k: (None if v is None else v.clone())
           for k, v in dec.weights.items()}
    alt["alpha"][::2] = alt["alpha"][::2, :1]
    gen = torch.Generator(device=card).manual_seed(12)
    v2c = _messages(gen, (dec.qc.num_blocks, 16, B), dtype, card)
    for t in (0, 1):
        _close(*_row_outputs(dec, v2c, alt, t), dtype)


@pytest.mark.parametrize("B", [96, 37], ids=["B96", "B37"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wide_row_matches_plain(card, dtype, B):
    """Rows of degree 70 and 66 (above the 64 sign bits a thread keeps in
    a register: the generic instance reads each message again for its
    sign), OMS-RCQ with trained weights, bit for bit."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 8, size=(2, 70))
    base[1, :4] = -1
    code = lt.create_qc_code(base, lift=8, max_iterations=T)
    dec = lt.make_decoder(code, max_iterations=T,
                          qc=lt.build_qc_graph(base, 8), **KINDS["orcq_t2"])
    assert [len(r) for r in dec.qc.row_blocks] == [70, 66]
    gen = torch.Generator(device=card).manual_seed(13)
    v2c = _messages(gen, (dec.qc.num_blocks, 8, B), dtype, card)
    for t in (0, T - 1):
        _close(*_row_outputs(dec, v2c, dec.weights, t), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_zoo_rows_match_plain(card, dtype):
    """K5 on every row of the zoo decoder (dc = 37, every row sharing
    (beta, alpha)) at t = 0 and T-1, at B = 4096 (8-byte accesses) and
    B = 1029 (frame by frame), bit for bit."""
    dec = lt.load_pretrained("worcq_bc3_qc9472")
    gen = torch.Generator(device=card).manual_seed(14)
    for B in (4096, 1029):
        v2c = (3.0 * torch.randn((dec.qc.num_blocks, dec.qc.lift, B),
                                 generator=gen, device=card)).to(dtype)
        for t in (0, dec.max_iterations - 1):
            _close(*_row_outputs(dec, v2c, dec.weights, t), dtype)
