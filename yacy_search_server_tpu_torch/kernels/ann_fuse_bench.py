"""K15 `ann_fuse` alone, on the card: the dense-first path's probe, dot
and fused top-k over a synthetic hot slab of clustered rows. Each
shape's answer is held against the kernel's plain version; then the
call ms and device ms, the device operations a call (a profiler trace),
the bytes bound, the PyTorch yardstick (a gather, a bf16 einsum and a
sort of the keys) and an empty kernel's call and device ms on the same
queue (the latency floor beside the bytes bound).

    python -m yacy_search_server_tpu_torch.kernels.ann_fuse_bench
        [--tag T] [--out FILE] [--check] [--shapes S]
    python -P yacy_search_server_tpu_torch/kernels/ann_fuse_bench.py
        --tree DIR

--tree times the package of another checkout (a parent commit) in place
of this one (-P keeps this file's folder off the import path); --check
holds the answers and times nothing; --shapes takes a subset, as
"1x32768x32,16x1024x16" (slots x nb x kk).

The slab: CAP int8 rows of 256 in clusters of CLUSTER consecutive rows,
f16 scales, docids a permutation. A slot probes NPROBE clusters of a
pool of POOL (so that the slots of a wave share rows, as one group of
the dense-first mix does), a lane a row, and holds a ninth more sparse
lanes with docids of their own (a third without a hot row, the rest on
rows of its clusters): 16,699 lanes at nb 32768, as the smoke's solo
slot. Shapes: one slot and a 16-slot wave at nb 32768, kk 32 (the mix's
commonest group), 16 slots at nb 1024, kk 16 (900 lanes); kk 2048 and
8192 at nb 32768 for the answers only.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

CAP = 1 << 20
CLUSTER = 1_850
NPROBE = 8
POOL = 24
SEED = 20261018
SHAPES = [(1, 32768, 32), (16, 32768, 32), (16, 1024, 16)]
ANSWERS_ONLY = [(16, 32768, 2048), (4, 32768, 8192)]


def make_slab(rng):
    """(slab int8 [CAP, 256], scales f16 [CAP], docids int32 [CAP])."""
    slab = rng.integers(-127, 128, (CAP, 256), dtype=np.int8)
    scales = (rng.random(CAP) / 127).astype(np.float16)
    sdoc = (rng.permutation(CAP).astype(np.int32) * 3)
    return slab, scales, sdoc


def make_wave(rng, bs: int, nb: int):
    """[bs, 2 + 3nb + 256] int32 descriptors (ops/ann.pack_ann_fuse_row)."""
    from yacy_search_server_tpu_torch.ops import ann as A
    pool = rng.choice(CAP // CLUSTER, POOL, replace=False) * CLUSTER
    per = min(CLUSTER, max(1, (nb * 8 // 9) // NPROBE))
    qi = []
    for _ in range(bs):
        q = rng.standard_normal(256).astype(np.float32)
        q /= np.linalg.norm(q)
        starts = rng.choice(pool, NPROBE, replace=False)
        probe = np.concatenate([s + np.arange(per) for s in starts])
        m = min(nb - probe.size, probe.size // 8)
        rows = np.concatenate([probe, rng.choice(probe, m)]).astype(np.int32)
        dd = np.full(rows.size, -1, np.int32)
        sp = np.zeros(rows.size, np.int32)
        dd[probe.size:] = rng.integers(0, 1 << 30, m)
        sp[probe.size:] = rng.integers(0, 1 << 24, m)
        rows[probe.size:probe.size + m // 3] = -1
        qi.append(A.pack_ann_fuse_row(q, rows, dd, sp, 0.5, nb))
    return np.stack(qi)


def run_shape(bs, nb, kk, dev, hb, qi, check_only: bool):
    from yacy_search_server_tpu_torch.kernels import ann as KA
    from yacy_search_server_tpu_torch.kernels import bench as KB
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    qd = KDn.upload_desc(qi, dev)
    kern = lambda: KA.ann_fuse(*hb, qd, nb, kk, bs)  # noqa: E731
    got = kern()
    want = KA.ann_fuse_plain(*hb, qd, nb, kk)
    torch.cuda.synchronize()
    row = {"bs": bs, "nb": nb, "kk": kk,
           "err": float((got.to(torch.int64) - want.to(torch.int64))
                        .abs().max())}
    rows_all = qi[:, 2:2 + nb]
    live = np.arange(nb)[None, :] < qi[:, :1]
    in_slab = live & (rows_all >= 0) & (rows_all < CAP)
    distinct = int(np.unique(rows_all[in_slab]).size)
    row.update(lanes=int(live.sum()), in_slab=int(in_slab.sum()),
               distinct_rows=distinct)
    if check_only:
        return row
    row["ms"] = KB.call_ms(kern)
    row["device_ms"] = KB.device_ms(kern)
    ops = KB.device_ops(kern)
    row["ops"] = len(ops)
    row["op_list"] = ops
    row["plain_ms"] = KB.call_ms(
        lambda: KA.ann_fuse_plain(*hb, qd, nb, kk), reps=3)
    # each in-slab row read once (256 B, its scale and docid), the
    # descriptors, the output, at 3.35 TB/s
    row["bound_ms"] = (distinct * 262 + qi.nbytes + bs * 2 * kk * 4) \
        / 3.35e12 * 1e3
    bf = torch.bfloat16
    idx = torch.from_numpy(np.clip(rows_all, 0, CAP - 1).astype(
        np.int64)).to(dev)
    q_b = torch.from_numpy(qi[:, 2 + 3 * nb:].copy().view(
        np.float32)).to(dev).to(bf)
    keys = torch.from_numpy(rows_all.astype(np.int64)).to(dev)
    lib = lambda: (torch.einsum("bd,bnd->bn", q_b,  # noqa: E731
                                hb[0][idx].to(bf)),
                   torch.sort(keys, dim=1))
    row["library_ms"] = KB.call_ms(lib)
    row["library_device_ms"] = KB.device_ms(lib)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="ann_fuse")
    ap.add_argument("--tree", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--shapes", default=None)
    args = ap.parse_args(argv)
    shapes = SHAPES if not args.shapes else [
        tuple(int(v) for v in x.split("x")) for x in args.shapes.split(",")]
    # this checkout's root, or the other tree's
    sys.path.insert(0, args.tree or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    from yacy_search_server_tpu_torch.kernels import bench as KB
    from yacy_search_server_tpu_torch.kernels import scan_batch_bench as SBB
    if not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        return 2
    t0 = time.time()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    hb = tuple(torch.from_numpy(a).to(dev) for a in make_slab(rng))
    waves = {(bs, nb): make_wave(rng, bs, nb)
             for bs, nb, _kk in shapes + ANSWERS_ONLY}
    print(f"[{args.tag}] {SBB.card()}; set-up {time.time() - t0:.1f} s",
          flush=True)
    out = []
    if not args.check:
        empty = {"tag": args.tag, "empty_ms": KB.call_ms(KB.empty_launch),
                 "empty_device_ms": KB.device_ms(KB.empty_launch)}
        print(json.dumps(empty), flush=True)
    for (bs, nb, kk), only in [(s, args.check) for s in shapes] + [
            (s, True) for s in ANSWERS_ONLY]:
        row = {"tag": args.tag, **run_shape(bs, nb, kk, dev, hb,
                                            waves[(bs, nb)], only)}
        print(json.dumps(row), flush=True)
        out.append(row)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(f"[{args.tag}] done {time.time() - t0:.1f} s", flush=True)
    return 0 if all(r["err"] == 0 for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
