#!/usr/bin/env python3
"""Time the port's kernels as built from several source trees, on one card.

    python3 tests_gpu/time_kernels.py [--src NAME=CSRC_DIR ...] [--sass]
        [--out FILE]

Each ``--src`` names a directory of kernel sources (``*.cu``, ``*.cuh``
with the C entry points of ``ldpc_tpu_torch/csrc``, e.g. the ``csrc`` of
an older commit unpacked with ``git archive``); the package's own
``ldpc_tpu_torch/csrc`` is always added as ``this``. Every tree is built
with the package's nvcc flags (``decode/_build.py``), then loaded in place
of the package's library, so the same wrappers launch its kernels on the
same inputs:

- K5, one launch on the zoo decoder's row 0 (dc = 37, every block sharing
  (beta, alpha)), B = 32768, bf16;
- K6, one launch on the zoo decoder's column 0 (dv = 5, bv = 8 power-law
  routing), B = 32768, bf16;
- K4, the zoo decoder (``worcq_bc3_qc9472``), bf16, lean, at B = 32768,
  T = 6 and at B = 8192, T = 10;
- K1, the bench decoder (``chip_smoke.BENCH_KW``), bf16, lean, at
  B = 32768, T = 3 and at B = 256, T = 6;
- the whole row/column decode (``qc_pallas_decode_batch``: 50 K5 and 370
  K6 launches and the torch ops between them) of the zoo decoder, B = 32768,
  bf16, T = 10, ``check_every=1``, on the K4 inputs (6.25 dB).

The trees are timed in two turns, in the order given and then reversed
(``a, b, b, a``), with CUDA events after a warm-up; each tree's outputs
must equal the first tree's bit for bit. ``--sass`` also prints, for the
K1, K4, K5 and K6 kernels of each tree, the static SASS instruction counts
(``cuobjdump -sass``) by kind and the registers and spills ptxas reported.
With ``--out``, one JSON object per measurement also goes to that file.
Needs a CUDA card and nvcc.
"""

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (sets the no-JAX guard, needs ROOT)
import torch  # noqa: E402

# the bf16 instances the timed calls run (K1's rcq instance with the state
# on chip, K4's and K5's orcq instances, K6's dv = 5), and those of older
# trees without the kind as a template parameter
KERNELS = ("fused_layered_kernelI13__nv_bfloat16E",
           "fused_layered_kernelI13__nv_bfloat16Li2ELi768ELb1E",
           "fused_flooding_kernelI13__nv_bfloat16E",
           "fused_flooding_kernelI13__nv_bfloat16Li4E",
           "qc_cn_kernelI13__nv_bfloat16E",
           "qc_cn_kernelI13__nv_bfloat16Li4ELb1E",
           "qc_vn_kernelI13__nv_bfloat16E", "qc_vn_kernelI13__nv_bfloat16Li5E")
OPS = ("MUFU", "CALL", "LDG", "LDS", "STS", "BAR", "FRND", "BRA", "FSETP",
       "FADD", "FMUL", "IMAD")


def sass_stats(so: Path):
    """{kernel instance: {total, op counts}} of the library's SASS."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(so)],
                         check=True, capture_output=True, text=True).stdout
    stats = {}
    for part in out.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if not any(k in name for k in KERNELS):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,6}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z0-9_]+)", part)
        c = collections.Counter(ops)
        stats[name] = dict(total=len(ops), **{k: c[k] for k in OPS})
    return stats


def adapt_old_layered(lib):
    """Give a library of older sources (K1 with a global c2v scratch
    [B, NB, L] in the storage type, before the compressed check state) the
    current K1 entry points: the wrapper's call is passed on with a
    scratch it allocates, as the wrapper of those sources did."""
    old = lib.ldpc_fused_layered
    P, I = ctypes.c_void_p, ctypes.c_int
    old.argtypes = [P] * 8 + [I, P, P, I, P, P, P, P] + [I] * 14 + [P]

    def call(*args):
        head, (B, nb, mb, NB, L, T, _dcmax, is_bf16), rest = \
            args[:16], args[16:24], args[24:]
        cmem = torch.empty((B, NB * L * (2 if is_bf16 else 4)),
                           dtype=torch.uint8, device="cuda")
        return old(*head[:4], ctypes.c_void_p(cmem.data_ptr()), *head[5:],
                   B, nb, mb, NB, L, T, is_bf16, *rest)

    lib.ldpc_fused_layered = call
    lib.ldpc_fused_layered_smem = lambda *sizes: 0  # sized at launch
    lib.ldpc_fused_layered_state_bytes = lambda *sizes: 0


class Inputs:
    """The inputs of every timed call, made once from seeded generators."""

    def __init__(self, dev):
        import ldpc_tpu_torch as lt
        import numpy as np
        gen = torch.Generator(device=dev).manual_seed(11)
        self.zdec = lt.load_pretrained(chip_smoke.ZOO_ENTRY)
        n = self.zdec.code.n
        self.rc = chip_smoke.RowColState(
            self.zdec, lt.awgn_llr(gen, torch.zeros((32768, n), device=dev),
                                   6.25), torch.bfloat16)
        self.o5 = torch.zeros_like(self.rc.v2c)
        self.o6 = (torch.empty_like(self.rc.v2c),
                   torch.empty_like(self.rc.llr_T))
        self.x4 = lt.awgn_llr(gen, torch.zeros((32768, n), device=dev),
                              6.25).to(torch.bfloat16)
        base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
        code = lt.create_qc_code(base, lift=256,
                                 max_iterations=chip_smoke.T)
        self.bdec = lt.make_decoder(code, qc=lt.build_qc_graph(base, 256),
                                    **chip_smoke.BENCH_KW)
        self.x1 = lt.awgn_llr(gen, torch.zeros((32768, n), device=dev),
                              chip_smoke.SNR_DB).to(torch.bfloat16)

    def calls(self):
        """(name, reps, fn -> tensors to compare)."""
        def k5():  # writes row 0's blocks; the rest stays zero
            self.rc.cn(0, 0, False, self.o5)
            return (self.o5,)

        def k6():
            self.rc.vn(0, 0, False, self.o6)
            return self.o6

        def k4(B, T):
            return lambda: chip_smoke.kernel_on(
                self.x4[:B], self.zdec, T, True, flooding=True)[::3]

        def k1(B, T):
            return lambda: chip_smoke.kernel_on(
                self.x1[:B], self.bdec, T, True)[::3]

        def rc():
            import ldpc_tpu_torch as lt
            out = lt.qc_pallas_decode_batch(
                self.x4, self.zdec.weights, qc=self.zdec.qc,
                spec=self.zdec.spec, max_iterations=10, check_every=1,
                dtype=torch.bfloat16, batch_tile=128)
            return out.bits, out.success

        return [("K5 row 0 B=32768", 20, k5),
                ("K6 col 0 B=32768", 20, k6),
                ("K4 B=32768 T=6", 5, k4(32768, 6)),
                ("K4 B=8192 T=10", 5, k4(8192, 10)),
                ("K1 B=32768 T=3", 5, k1(32768, 3)),
                ("K1 B=256 T=6", 20, k1(256, 6)),
                ("K5/K6 decode B=32768", 3, rc)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="NAME=DIR of kernel sources (repeatable)")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out", help="a file for the measurements as JSON lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    from ldpc_tpu_torch.decode import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    trees = [s.split("=", 1) for s in args.src] + [["this", str(_build._CSRC)]]
    build = ROOT / "ldpc_tpu_torch" / "_build" / "trees"
    libs = {}
    for name, src in trees:
        so = _build.build_library(Path(src), build)
        libs[name] = _build.open_library(so, strict=False)
        if not hasattr(libs[name], "ldpc_fused_flooding_smem"):
            # an older K4 sizes its shared memory itself, at launch; the
            # wrapper's check before the launch has nothing to ask
            libs[name].ldpc_fused_flooding_smem = lambda *sizes: 0
        if not hasattr(libs[name], "ldpc_fused_layered_smem"):
            adapt_old_layered(libs[name])
        if args.sass:
            regs = chip_smoke.ptxas_stats(so.with_suffix(".log"))
            for fn, st in sass_stats(so).items():
                print(f"[sass] {name:12s} {fn[-60:]}: {st} "
                      f"ptxas {regs.get(fn)}", flush=True)
    print(f"[card] {card}", flush=True)

    dev = torch.device("cuda")
    inp = Inputs(dev)
    names = [n for n, _ in trees]
    ref, records = {}, []
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            _build.load_library = lambda lib=libs[name]: lib
            for call, reps, fn in inp.calls():
                got = [t.clone() for t in fn()]
                torch.cuda.synchronize()
                if call not in ref:
                    ref[call] = got
                same = all(torch.equal(a, b) for a, b in zip(got, ref[call]))
                ms = chip_smoke.time_ms(fn, reps)
                records.append(dict(tree=name, call=call, turn=turn, ms=ms,
                                    equal_to_first=same, card=card))
                print(f"  {name:12s} {call:18s} turn {turn}: {ms:9.4f} ms"
                      f"  equal to {names[0]}: {same}  [{card}]", flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in records))
    bad = [r for r in records if not r["equal_to_first"]]
    if bad:
        raise SystemExit(f"outputs differ from {names[0]}: {bad}")


if __name__ == "__main__":
    main()
