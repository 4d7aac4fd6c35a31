"""Honest frame error counts of the PBRL V2C/CN probe programs' decoders
on the CPU through ``ldpc_tpu``, as the reference the port's FER on the
card is held to (``chip_smoke.py`` phase 22 reads the committed
``ldpc_tpu_torch/cli/pbrl_probe_reference.json``; the card's machine has
no jax).

The programs (``experiments/pbrl_bv10.py``, ``pbrl_cn_probe.py``,
``pbrl_vqp_sweep.py``, ``pbrl_vqp_gamma.py``) decode the precoded PBRL
code (``create_pbrl_qc_protograph(k=1032, rate=1/3, precode=True)``,
lift 86, n = 3182, the 86 bits of base column 0 punctured) with RCQ,
layered T=10, under the {5, 10} two-checkpoint rule. In the layered
schedule only the posterior passes through the V2C quantizer, so their
fourteen arms are five decoders; four have no honest record
(:data:`DECODERS`; the fifth is ``rcq-ref3``,
``experiments/pbrl_honest_dev.json``).

Each batch is ``--batch`` all-zero codewords over AWGN at ``--snr`` dB
drawn with ``jax.random`` from ``--seed`` (the key split once a batch, as
``tests/jax_reference_trio.py`` draws), the punctured LLRs zeroed. The
count route is ``ldpc_tpu``'s general layered engine (the base rows as
its layers) with its trajectory read at iterations 5 and 10: a frame is
in error under its iteration-5 decisions where they pass the syndrome,
else under its iteration-10 ones (100-150 frames a second a process
with eight processes on eight cores, bc=5 the slowest, where
``ldpc_tpu``'s interpret-mode kernel runs about 40). On the first
``--hold`` frames of the run the same frames also go through
``ldpc_tpu``'s fused kernel in interpret mode (the JAX program's own
decoder on the CPU, float32) and the port's K1 plain version in the same
two stages; any frame on which the three routes disagree fails the run.

``--procs P`` runs each decoder's ``--frames`` in P processes over
disjoint batch ranges (``--skip``), one XLA and one torch thread each,
and writes the merged counts with this command to ``--out``; with
``--skip N`` it runs the chain's batches from N on and adds them to the
file's entries, which must end at batch N:

    JAX_PLATFORMS=cpu python tests/jax_reference_probes.py --procs 8
        --out ldpc_tpu_torch/cli/pbrl_probe_reference.json
        [--decoders cn_6-12-12 ...] [--frames 262144] [--batch 2048]
        [--snr 2.0] [--seed 19] [--hold 2048]

Without ``--procs`` it counts one decoder (``--decoders NAME``) over
batches ``--skip`` to ``--skip + frames/batch - 1`` and prints a last line
``FINAL {json}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CN_REF3 = ((8.4963, 1.3), (12.108, 1.3), (12.108, 1.3))
VQP_REF3 = ((182.5928, 1.0), (315.3076, 1.0), (394.1345, 1.0))
T, T1 = 10, 5
# name -> (the program and arm it is counted as, the arms that decode as
# it, CN ladder, V2C ladder, bc, bv)
DECODERS = {
    "bc5_bv10": ("pbrl_bv10/bc5_bv10", ["pbrl_vqp_sweep/bc5_vr96"],
                 CN_REF3, VQP_REF3, 5, 10),
    "cn_8.5-16-16": ("pbrl_cn_probe/cn_8.5-16-16", [],
                     ((8.4963, 1.3), (16.0, 1.3), (16.0, 1.3)), VQP_REF3,
                     4, 8),
    "cn_6-12-12": ("pbrl_cn_probe/cn_6-12-12", [],
                   ((6.0, 1.3), (12.108, 1.3), (12.108, 1.3)), VQP_REF3,
                   4, 8),
    "cn_8.5-12-16": ("pbrl_cn_probe/cn_8.5-12-16", [],
                     ((8.4963, 1.3), (12.108, 1.3), (16.0, 1.3)), VQP_REF3,
                     4, 8),
}


def jax_routes(name, hold):
    """({route: llr [B, n] (numpy) -> errors [B] (bool)}, punctured
    positions) of ``ldpc_tpu``: ``engine``, and with ``hold`` also
    ``kernel`` (interpret mode, float32, the programs' CPU decoder)."""
    import jax
    import jax.numpy as jnp

    import ldpc_tpu
    from ldpc_tpu.decode.engine import decode_batch_layered
    from ldpc_tpu.decode.qc_engine import build_qc_graph

    _, _, cn, v2c, bc, bv = DECODERS[name]
    base, lift, pc = ldpc_tpu.create_pbrl_qc_protograph(
        k=1032, rate=1 / 3, precode=True)
    code = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T)
    kw = dict(kind="rcq", bc=bc, bv=bv, quantizer_params=cn,
              v2c_quantizer_params=v2c, max_iterations=T, layered=True,
              closed_qdq=bc >= 5)
    general = ldpc_tpu.make_decoder(code, **kw)
    layers = np.arange(code.H.shape[0]).reshape(-1, lift)
    Ht = scipy.sparse.csr_matrix(code.H.T.astype(np.float32))
    traj = jax.jit(lambda x: decode_batch_layered(
        x, general.weights, layers, graph=general.graph, spec=general.spec,
        max_iterations=T, return_trajectory=True).posteriors_all)

    def engine(llr):
        bits = np.asarray(traj(jnp.asarray(llr))) < 0     # [T, B, n]
        syn = (Ht.T @ bits[T1 - 1].T.astype(np.float32)).T % 2
        ok = ~syn.astype(bool).any(1)
        return np.where(ok, bits[T1 - 1].any(1), bits[-1].any(1))
    out = {"engine": engine}
    if hold:
        import dataclasses
        kernel = ldpc_tpu.make_decoder(
            code, qc=build_qc_graph(base, lift), qc_options=dict(
                fused=True, batch_tile=None, interpret=True,
                dtype=jnp.float32), **kw)
        short = dataclasses.replace(kernel, qc_options=None).truncated(T1)
        short = dataclasses.replace(short, qc_options=kernel.qc_options)

        def fused(llr):
            o1 = short(jnp.asarray(llr))
            ok = np.asarray(o1.success)
            err = np.where(ok, np.asarray(o1.bits).any(1), True)
            surv = np.flatnonzero(~ok)
            if surv.size:   # one padded shape: one interpret-mode compile
                rows = np.zeros_like(llr)
                rows[:surv.size] = llr[surv]
                err[surv] = np.asarray(
                    kernel(jnp.asarray(rows)).bits).any(1)[:surv.size]
            return err
        out["kernel"] = fused
    return out, tuple(range(lift * pc[0], lift * (pc[0] + 1)))


def port_k1(name):
    """The port's K1 plain version of the twin's arm, in the simulator's
    two stages: llr -> errors."""
    import importlib

    import torch

    from ldpc_tpu_torch.decode.early_exit import two_checkpoint_stages

    prog, arm = DECODERS[name][0].split("/")
    mod = importlib.import_module(f"ldpc_tpu_torch.cli.{prog}")
    dec = mod.build_arms("cpu")[0][arm]
    stage1, stage2 = two_checkpoint_stages(dec, T1)

    def plain(llr):
        x = torch.from_numpy(llr)
        with torch.no_grad():
            o1 = stage1(x, dec.weights)
            ok = o1.success.numpy()
            err = np.where(ok, o1.bits.numpy().any(1), True)
            surv = np.flatnonzero(~ok)
            if surv.size:
                err[surv] = stage2(x[torch.from_numpy(surv)],
                                   dec.weights).bits.numpy().any(1)
        return err
    return plain


def count(args):
    """One decoder over this process's batches; prints ``FINAL {json}``."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    torch.set_num_threads(1)

    name = args.decoders[0]
    routes, punct = jax_routes(name, args.hold)
    if args.hold:
        routes["port_k1"] = port_k1(name)
    n = 3182
    sigma2 = 10.0 ** (-args.snr / 10.0)
    mask = np.ones(n, np.float32)
    mask[list(punct)] = 0.0
    key = jax.random.PRNGKey(args.seed)
    for _ in range(args.skip):
        key, _k = jax.random.split(key)
    errors, held, apart, frames = 0, 0, 0, 0
    t0 = time.time()
    while frames < args.frames:
        key, k = jax.random.split(key)
        y = 1.0 + jnp.sqrt(sigma2) * jax.random.normal(k, (args.batch, n))
        llr = np.asarray(2.0 * y / sigma2, np.float32) * mask
        err = routes["engine"](llr)
        if held < args.hold:
            for r in ("kernel", "port_k1"):
                apart += int((routes[r](llr) != err).sum())
            held += args.batch
        errors += int(err.sum())
        frames += args.batch
        print(f"{name} batch {args.skip + frames // args.batch - 1}: "
              f"{frames} frames, {errors} errors, held {held} (apart "
              f"{apart}), {time.time() - t0:.0f} s", flush=True)
    print("FINAL " + json.dumps(dict(
        name=name, skip=args.skip, frames=frames, errors=errors,
        held=held, apart=apart, seconds=round(time.time() - t0, 1))),
        flush=True)
    if apart:
        raise SystemExit(f"{name}: the routes disagree on {apart} frames")


def launch(args, argv):
    """Every decoder's frames over ``--procs`` processes; the merged
    counts go to ``--out``."""
    per = -(-args.frames // args.batch)
    chunks = max(1, args.procs // len(args.decoders))
    jobs, step = [], -(-per // chunks)
    for name in args.decoders:
        for skip in range(args.skip, args.skip + per, step):
            jobs.append((name, skip, min(step, args.skip + per - skip)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    finals, running = [], []
    for name, skip, nb in jobs:
        while len(running) >= args.procs:
            finals += _reap(running)
        cmd = [sys.executable, os.path.abspath(__file__), "--decoders",
               name, "--skip", str(skip), "--frames", str(nb * args.batch),
               "--batch", str(args.batch), "--snr", str(args.snr),
               "--seed", str(args.seed),
               "--hold", str(args.hold if skip == 0 else 0)]
        running.append((subprocess.Popen(cmd, env=env, cwd=REPO,
                                         stdout=subprocess.PIPE,
                                         text=True), name, skip))
    while running:
        finals += _reap(running)
    out, before = {}, {}
    if args.skip:   # more batches of the same chain, added to the file's
        with open(args.out) as f:
            out = before = json.load(f)
    command = ("JAX_PLATFORMS=cpu python tests/jax_reference_probes.py "
               + " ".join(argv))
    for name in args.decoders:
        mine = [f for f in finals if f["name"] == name]
        counted, arms, cn, v2c, bc, bv = DECODERS[name]
        if name in before:
            e = before[name]
            if (e["seed"], e["snr"], e["batch"]) != (
                    args.seed, args.snr, args.batch) or \
                    e["frames"] != args.skip * args.batch:
                raise SystemExit(f"{name}: batches {args.skip}- do not "
                                 f"follow the file's {e}")
            for k, v in (("frames", "frames"), ("errors", "errors"),
                         ("held", "held"), ("apart", "apart"),
                         ("process_seconds", "seconds")):
                e[k] = round(e[k] + sum(f[v] for f in mine), 1)
            e["command"] += "; then " + command
            continue
        out[name] = dict(
            counted_as=counted, same_decode=arms, cn=cn, v2c=v2c, bc=bc,
            bv=bv, closed_qdq=bc >= 5, T=T, t1=T1, snr=args.snr,
            seed=args.seed, batch=args.batch,
            frames=sum(f["frames"] for f in mine),
            errors=sum(f["errors"] for f in mine),
            held=sum(f["held"] for f in mine),
            apart=sum(f["apart"] for f in mine),
            process_seconds=round(sum(f["seconds"] for f in mine), 1),
            command=command)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out, indent=1))


def _reap(running):
    """Wait for the first process of ``running`` and take its FINAL."""
    proc, name, skip = running.pop(0)
    text, _ = proc.communicate()
    final = [ln for ln in text.splitlines() if ln.startswith("FINAL ")]
    if proc.returncode or not final:
        raise SystemExit(f"{name} from batch {skip}: rc {proc.returncode}"
                         f"\n{text[-3000:]}")
    print(final[-1], flush=True)
    return [json.loads(final[-1][6:])]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decoders", nargs="+", choices=list(DECODERS),
                    default=list(DECODERS))
    ap.add_argument("--frames", type=int, default=262144)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--snr", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--skip", type=int, default=0)
    ap.add_argument("--hold", type=int, default=2048)
    ap.add_argument("--procs", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    if args.procs:
        return launch(args, argv)
    if len(args.decoders) != 1:
        raise SystemExit("without --procs, name one decoder")
    count(args)


if __name__ == "__main__":
    main()
