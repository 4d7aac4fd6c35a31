"""The frame errors of the precoded-PBRL training programs' plain RCQ arms
on the CPU, route by route on the same LLRs: ``ldpc_tpu``'s decoders and
the port's, as a reference for the port's FER on the card.

The arm is ``experiments/pbrl_wrcq.py``'s ``rcq-<tag>`` decoder (RCQ
bc=4, bv=8, layered T=10, the CN and V2C ladders of ``_ladder(tag)``) on
``create_pbrl_qc_protograph(k=1032, rate=1/3, precode=True)`` (lift 86, n
= 3182), in float32. The routes (``--routes``, any of):

- ``engine``: ``ldpc_tpu``'s layered engine on the code's general graph,
  the base rows as its layers, its trajectory read at iterations 5 and
  10 (it compiles in seconds where the interpret-mode kernel on this base
  takes a minute);
- ``qc_engine``: ``ldpc_tpu``'s layered QC engine, ``check_every=5``;
- ``kernel``: ``ldpc_tpu``'s fused kernel in interpret mode (the JAX
  program's own decoder on the CPU), 5 iterations on every frame and 10
  on the frames that fail the syndrome there, as ``ldpc_tpu``'s
  simulator runs it;
- ``port_k1``: the port's K1 plain version in the same two stages
  (``two_checkpoint_stages``);
- ``port_engine``: the port's layered QC engine, ``check_every=5``.

Each batch is ``--batch`` all-zero codewords over AWGN at ``--snr`` dB
drawn with ``jax.random`` from ``--seed`` (the key split once a batch),
the 86 LLRs of base column 0 zeroed (punctured). A frame is in error under
the simulator's {5, 10} rule: its iteration-5 decisions where they pass
the syndrome, else its iteration-10 ones. ``--skip`` starts at that batch
of the seed's chain, so that processes can share one run. Prints each
batch's running errors by route and, for each pair of routes, the frames
on which they disagree, and a last line ``FINAL <tag> <frames> <errors by
route> <disagreements>``. CPU only; the engine alone takes about 400
frames a second, all five routes about 40:

    JAX_PLATFORMS=cpu python tests/jax_reference_trio.py --tag ref2
        [--routes engine kernel port_k1 ...] [--frames 983040]
        [--batch 2048] [--snr 2.0] [--seed 7] [--skip 0]

``--card FILE`` instead holds K1's float32 posteriors from the card at T=5
and T=10 (``tests_gpu/trio_dtype_probe.py --dump FILE``) to the port's K1
plain version and ``ldpc_tpu``'s interpret-mode kernel on the CPU, on the
same LLRs, bit for bit, and prints how many values part.
"""

import argparse
import dataclasses
import itertools
import os
import sys
import time

import numpy as np
import scipy.sparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = ("engine", "qc_engine", "kernel", "port_k1", "port_engine")


def jax_routes(tag, names):
    """{route: llr [B, n] (numpy) -> errors [B] (bool)} of ``ldpc_tpu``'s
    routes in ``names``, and the punctured positions."""
    import jax
    import jax.numpy as jnp

    import experiments.pbrl_wrcq as prog
    import ldpc_tpu
    from ldpc_tpu.decode.engine import decode_batch_layered

    arms, punct = prog.build_arms((f"rcq-{tag}",))
    kernel = arms[f"rcq-{tag}"]            # fused, interpret mode, float32
    code, lift, T = kernel.code, kernel.qc.lift, prog.T
    Ht = scipy.sparse.csr_matrix(code.H.T.astype(np.float32))
    out = {}
    if "engine" in names:
        layers = np.arange(code.H.shape[0]).reshape(-1, lift)
        qp, vqp = prog._ladder(tag)
        general = ldpc_tpu.make_decoder(
            code, kind="rcq", bc=4, bv=8, quantizer_params=qp,
            v2c_quantizer_params=vqp, max_iterations=T, layered=True)
        traj = jax.jit(lambda x: decode_batch_layered(
            x, general.weights, layers, graph=general.graph,
            spec=general.spec, max_iterations=T,
            return_trajectory=True).posteriors_all)

        def engine(llr):
            bits = np.asarray(traj(jnp.asarray(llr))) < 0     # [T, B, n]
            t1 = bits[4]
            syn = (Ht.T @ t1.T.astype(np.float32)).T % 2
            ok = ~syn.astype(bool).any(1)
            return np.where(ok, t1.any(1), bits[-1].any(1))
        out["engine"] = engine
    if "qc_engine" in names:
        qc_engine = dataclasses.replace(kernel,
                                        qc_options=dict(check_every=5))
        out["qc_engine"] = lambda llr: np.asarray(
            qc_engine(jnp.asarray(llr)).bits).any(1)
    if "kernel" in names:
        short = dataclasses.replace(kernel, qc_options=None).truncated(5)
        short = dataclasses.replace(short, qc_options=kernel.qc_options)

        def fused(llr):
            o1 = short(jnp.asarray(llr))
            ok = np.asarray(o1.success)
            err = np.where(ok, np.asarray(o1.bits).any(1), True)
            surv = np.flatnonzero(~ok)
            if surv.size:   # one padded shape: one interpret-mode compile
                S = 256 if surv.size <= 256 else len(llr)
                rows = np.zeros((S, llr.shape[1]), np.float32)
                rows[:surv.size] = llr[surv]
                err[surv] = np.asarray(
                    kernel(jnp.asarray(rows)).bits).any(1)[:surv.size]
            return err
        out["kernel"] = fused
    return out, punct


def port_routes(tag, names):
    """{route: llr -> errors} of the port's routes in ``names`` (CPU)."""
    import torch

    from ldpc_tpu_torch.cli import pbrl_wrcq as pw
    from ldpc_tpu_torch.decode.early_exit import two_checkpoint_stages

    arms, _ = pw.build_arms((f"rcq-{tag}",), "cpu")
    k1 = arms[f"rcq-{tag}"]
    out = {}
    if "port_k1" in names:
        stage1, stage2 = two_checkpoint_stages(k1, 5)

        def plain(llr):
            x = torch.from_numpy(llr)
            with torch.no_grad():
                o1 = stage1(x, k1.weights)
                ok = o1.success.numpy()
                err = np.where(ok, o1.bits.numpy().any(1), True)
                surv = np.flatnonzero(~ok)
                if surv.size:
                    err[surv] = stage2(x[torch.from_numpy(surv)],
                                       k1.weights).bits.numpy().any(1)
            return err
        out["port_k1"] = plain
    if "port_engine" in names:
        engine = dataclasses.replace(k1, qc_options=dict(check_every=5))

        def port_engine(llr):
            with torch.no_grad():
                return engine(torch.from_numpy(llr)).bits.numpy().any(1)
        out["port_engine"] = port_engine
    return out


def card_check(path, tag):
    """K1's posteriors from the card (``path``) against the port's plain
    version and ``ldpc_tpu``'s kernel on the CPU, at T=5 and T=10."""
    import jax.numpy as jnp
    import torch

    import experiments.pbrl_wrcq as prog
    from ldpc_tpu_torch.cli import pbrl_wrcq as pw
    from ldpc_tpu_torch.decode.early_exit import two_checkpoint_stages

    with np.load(path) as f:
        llr, card = f["llr"], {5: f["post5"], 10: f["post10"]}
    k1 = pw.build_arms((f"rcq-{tag}",), "cpu")[0][f"rcq-{tag}"]
    kernel = prog.build_arms((f"rcq-{tag}",))[0][f"rcq-{tag}"]
    short = dataclasses.replace(kernel, qc_options=None).truncated(5)
    jax_dec = {5: dataclasses.replace(short, qc_options=kernel.qc_options),
               10: kernel}
    with torch.no_grad():
        port = dict(zip((5, 10), (
            s(torch.from_numpy(llr), k1.weights).posterior.numpy()
            for s in two_checkpoint_stages(k1, 5))))
    for T in (5, 10):
        jax_post = np.asarray(jax_dec[T](jnp.asarray(llr)).posterior)
        for who, post in (("port plain", port[T]), ("ldpc_tpu", jax_post)):
            apart = int((card[T].view(np.int32) != post.view(np.int32)).sum())
            print(f"rcq-{tag} T={T}: the card's K1 against {who} on the CPU, "
                  f"{len(llr)} frames: {apart} of {post.size} posterior "
                  f"values apart, hard decisions apart in "
                  f"{int(((card[T] < 0) != (post < 0)).any(1).sum())} frames",
                  flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="ref2")
    ap.add_argument("--routes", nargs="+", choices=ROUTES,
                    default=["engine"])
    ap.add_argument("--frames", type=int, default=983040)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--snr", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--skip", type=int, default=0)
    ap.add_argument("--card", default=None)
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    card = args.card and os.path.abspath(args.card)
    os.chdir(REPO)   # the program reads experiments/... relative paths
    if card:
        return card_check(card, args.tag)
    routes, punct = jax_routes(args.tag, args.routes)
    routes.update(port_routes(args.tag, args.routes))
    routes = {r: routes[r] for r in ROUTES if r in routes}
    n = 3182
    sigma2 = 10.0 ** (-args.snr / 10.0)
    mask = np.ones(n, np.float32)
    mask[list(punct)] = 0.0
    key = jax.random.PRNGKey(args.seed)
    errors = dict.fromkeys(routes, 0)
    apart = {f"{a}/{b}": [] for a, b in itertools.combinations(routes, 2)}
    frames, batch = 0, args.skip
    t0 = time.time()
    for _ in range(args.skip):
        key, _k = jax.random.split(key)
    while frames < args.frames:
        key, k = jax.random.split(key)
        y = 1.0 + jnp.sqrt(sigma2) * jax.random.normal(k, (args.batch, n))
        llr = np.asarray(2.0 * y / sigma2, np.float32) * mask
        err = {r: f(llr) for r, f in routes.items()}
        for r in routes:
            errors[r] += int(err[r].sum())
        for a, b in itertools.combinations(routes, 2):
            apart[f"{a}/{b}"] += [(batch, int(i)) for i in
                                  np.flatnonzero(err[a] != err[b])]
        frames += args.batch
        batch += 1
        print(f"rcq-{args.tag} batch {batch - 1}: {frames} frames, errors "
              f"{errors}, apart {({k: len(v) for k, v in apart.items()})}, "
              f"{time.time() - t0:.0f} s", flush=True)
    print(f"FINAL rcq-{args.tag} {frames} {errors} apart (batch, frame) "
          f"{apart} ({{5, 10}}; {args.snr} dB, seed {args.seed}, batches "
          f"{args.skip}-{batch - 1} of {args.batch}, "
          f"{time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
