"""K9's similarity mode (`dense_sims`) and K17 (`power_iterate`) alone on
the card, at the shapes chip_smoke times them and at the edges of their
designs: each result held against the plain version, then (without
--check) its call ms, device ms, device operations and yardstick.

    python -m yacy_search_server_tpu_torch.kernels.k9_k17_bench [--tag T]
        [--check] [--out FILE]
    python -P yacy_search_server_tpu_torch/kernels/k9_k17_bench.py --tree DIR

--tree times the package of another checkout (a parent commit) in place of
this one (-P keeps this file's folder off the import path).
K9 runs over 2^21 + 7 f16 unit rows made on the card from a seed (the
first 2^21 of them for the power-of-two shapes) at B = 1, 16, 32 and 33
(two passes), B = 16 over all 2^21 + 7 (a ragged tile), and B = 16 with
one query element near 1e-35 (the pass takes mul + add where the others
take the fma). Yardstick: one `torch.matmul` of the bf16 queries and rows.
K17 runs over kernels/bench.host_graph (1,000,000 hosts, about 5.2M edges,
a 45,139-in-edge hub) and a 50,000-in-edge hub among 300,000 uniform
edges: `launch` over a prepared layout, the whole call and the layout
alone. Yardstick: the same steps
with cuSPARSE's CSR mat-vec (torch.sparse), the dangling sum and the
update in torch. Bounds: K9 the rows read once and the output written;
K17 12 bytes an edge and 8 a host a step, and the chain bound, the
largest in-degree's dependent adds at 4 cycles each and the card's
maximum SM clock."""

import argparse
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HBM = 3.35e12          # bytes a second (H100 SXM)


def max_sm_mhz() -> float:
    """The card's maximum SM clock, MHz (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30)
    return float(out.stdout.split()[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="k9k17")
    ap.add_argument("--tree", default=None)
    ap.add_argument("--check", action="store_true",
                    help="hold every shape against its plain version only")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.tree:
        sys.path.insert(0, args.tree)
    from yacy_search_server_tpu_torch.kernels import bench as KB
    from yacy_search_server_tpu_torch.kernels import blockrank as KBr
    from yacy_search_server_tpu_torch.kernels import build as B
    from yacy_search_server_tpu_torch.kernels import dense as KDn

    t0 = time.time()
    dev = torch.device("cuda")
    B.library()
    rows, bad = [], []
    bf = torch.bfloat16

    def emit(row):
        row["tag"] = args.tag
        print(json.dumps(row), flush=True)
        rows.append(row)

    def timed(fn):
        return {"ms": KB.call_ms(fn), "device_ms": KB.device_ms(fn)}

    # -- K9, similarity mode ------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(9)
    n_all = (1 << 21) + 7
    docs_all = torch.empty((n_all, 256), dtype=torch.float16, device=dev)
    for r0 in range(0, n_all, 1 << 18):
        v = torch.randn((min(1 << 18, n_all - r0), 256), generator=gen,
                        device=dev)
        docs_all[r0:r0 + len(v)] = v / v.norm(dim=1, keepdim=True)
    q40 = torch.randn((40, 256), generator=gen, device=dev)
    q40 /= q40.norm(dim=1, keepdim=True)
    tiny = q40[:16].clone()
    tiny[3, ::5] = 1e-35
    docs = docs_all[:1 << 21]
    shapes = [("B=1 over 2^21 rows", docs, q40[:1]),
              ("B=16 over 2^21 rows", docs, q40[:16]),
              ("B=32 over 2^21 rows", docs, q40[:32]),
              ("B=33 over 2^21 rows (two passes)", docs, q40[:33]),
              ("B=16 over 2^21 + 7 rows (a ragged tile)", docs_all, q40[:16]),
              ("B=16 over 2^21 rows, a query element of 1e-35 (mul + add)",
               docs, tiny)]
    if args.check:
        shapes += [(f"check B={b} over {n} rows", docs_all[:n], q40[:b])
                   for b in (1, 2, 3, 5, 31, 40) for n in (1, 127, 129)]
    for label, d_, q_ in shapes:
        got = KDn.dense_sims(d_, q_)
        want = KDn.dense_sims_plain(d_, q_)
        e = float((got - want).abs().max())
        same = bool(torch.equal(got, want))
        row = {"kernel": "dense_dot (similarity)", "shape": label, "err": e,
               "equal": same}
        if not same:
            bad.append(label)
        del got, want
        if not args.check:
            row.update(timed(lambda: KDn.dense_sims(d_, q_)))
            row["ops"] = KB.device_ops(lambda: KDn.dense_sims(d_, q_))
            d16 = d_.to(bf)
            row["library"] = timed(lambda: torch.matmul(q_.to(bf), d16.T))
            del d16
            nb, b = d_.shape[0], q_.shape[0]
            passes = -(-b // 32)
            row["bound_ms"] = (passes * nb * 512 + b * 1024 + b * nb * 4) \
                / HBM * 1e3
        emit(row)
    del docs, docs_all, shapes
    torch.cuda.empty_cache()
    print(f"[{args.tag}] K9 done {time.time() - t0:.1f} s", flush=True)

    # -- K17 ---------------------------------------------------------------
    mhz = max_sm_mhz()
    graphs = [("realistic host graph", KB.host_graph()),
              ("a 50,000-in-edge hub among 300,000 uniform edges",
               KB.edge_list(100_003, 300_000, KB.SEED + 100_003, 50_000))]
    for label, g in graphs:
        n, e = len(g[3]), len(g[0])
        cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in g]
        want, want_steps = KBr.power_iterate_plain(*cpu, 0.85, n)
        gd = [a.to(dev) for a in cpu]
        got, steps = KBr.power_iterate(*gd, 0.85, n)
        same = steps == want_steps and bool(torch.equal(
            got.cpu().view(torch.int32), want.view(torch.int32)))
        max_deg = int(np.bincount(g[1], minlength=n).max())
        lay = KBr.layout(*gd, n)
        KBr.launch(lay, 0.85)
        st = lay["state"].cpu()
        same = same and int(st[1]) == want_steps and bool(torch.equal(
            lay["rb"][int(st[4])].cpu().view(torch.int32),
            want.view(torch.int32)))
        row = {"kernel": "power_iterate", "shape": label,
               "steps": want_steps, "equal": same, "max_in_degree": max_deg}
        if "n_hub" in lay:
            row["hubs"], row["medium"] = lay["n_hub"], lay["n_med"]
        if not same:
            bad.append(label)
        if not args.check:
            row.update(timed(lambda: KBr.launch(lay, 0.85)))
            row["ops"] = KB.device_ops(lambda: KBr.launch(lay, 0.85))
            row["bound_ms"] = (12 * e + 8 * n) * want_steps / HBM * 1e3
            row["chain_bound_ms"] = max_deg * want_steps * 4 / (mhz * 1e3)
            row["max_sm_mhz"] = mhz
            row["whole_call_ms"] = KB.call_ms(
                lambda: KBr.power_iterate(*gd, 0.85, n))
            row["layout_ms"] = KB.call_ms(lambda: KBr.layout(*gd, n))
            d, inv, tele, r0, _tol = KBr.step_consts(0.85, n)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                csr = torch.sparse_csr_tensor(
                    lay["rowptr"].long(), lay["src_s"].long(), lay["w_s"],
                    size=(n, n))

            def lib():
                r_ = torch.full((n,), float(r0), device=dev)
                for _ in range(want_steps):
                    dm_ = torch.where(gd[3], r_, 0.0).sum() * float(inv)
                    r2_ = float(tele) + float(d) * (csr @ r_ + dm_)
                    (r2_ - r_).abs().max()
                    r_ = r2_
                return r_
            row["library"] = timed(lib)
            del csr
        emit(row)
        del lay
    print(f"[{args.tag}] K17 done {time.time() - t0:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    if bad:
        print(f"[{args.tag}] DISAGREE: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
