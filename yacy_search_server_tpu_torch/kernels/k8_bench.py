"""K8 (`join_member`, `join_member_batch`) alone at the shapes chip_smoke
times it, on a synthetic arena on the card: each result held against the
plain version, then its call ms, device ms and device operations.

    python -m yacy_search_server_tpu_torch.kernels.k8_bench [--tag T]
        [--out FILE]
    python -P yacy_search_server_tpu_torch/kernels/k8_bench.py --tree DIR

--tree times the package of another checkout (a parent commit, a patched
copy) in place of this one (-P keeps this file's folder off the import
path); --out writes the rows as JSON. The terms
follow chip_smoke's: the headline (10M docids 2i + 1) as a bitmap
partner, joinA (4M of [0, 40M)) as its rare span; term1000000 (docids
2i + 1) against joinB (30,000 of [0, 40M)) and joinC (2M of [0, 80M))
in sort mode, joinC past what a block stages whole; the waves at 16
bitmap slots and 4 sort slots under the mix's four filters."""

import argparse
import json
import sys
import time

import numpy as np
import torch


def _terms(rng):
    terms = {"hl": 2 * np.arange(10_000_000) + 1,
             "jA": np.sort(rng.choice(40_000_000, 4_000_000, replace=False)),
             "t1": 2 * np.arange(1_000_000) + 1,
             "jB": np.sort(rng.choice(40_000_000, 30_000, replace=False)),
             "jC": np.sort(rng.choice(80_000_000, 2_000_000, replace=False))}
    return {k: v.astype(np.int32) for k, v in terms.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="k8")
    ap.add_argument("--tree", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.tree:
        sys.path.insert(0, args.tree)
    from yacy_search_server_tpu_torch.index import devstore as TD
    from yacy_search_server_tpu_torch.kernels import bench as KB
    from yacy_search_server_tpu_torch.kernels import devstore as KD

    t0 = time.time()
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    terms = _terms(rng)
    # each term's rows in a random order (the store packs a term by its
    # score proxy), its join segment docid-sorted with each entry's row
    pad = 5
    perm = {k: rng.permutation(len(d)) for k, d in terms.items()}
    docids = np.concatenate([np.full(pad, -1, np.int32)]
                            + [terms[k][perm[k]] for k in terms])
    n = len(docids)
    start, jstart, at, jat = {}, {}, pad, 0
    for k, d in terms.items():
        start[k], jstart[k] = at, jat
        at += len(d)
        jat += len(d)
    f16 = rng.integers(0, 3000, (n, 17), dtype=np.int16)
    f16[:, 5] = np.where(rng.random(n) < 0.5, 0x656E, 0x6465)
    f16[:, 0] = rng.integers(0, 6000, n)
    flags = rng.integers(0, 2**30, n, dtype=np.int32)
    dead = np.zeros(80_000_000, bool)
    dead[rng.choice(40_000_000, 500, replace=False)] = True
    jd = np.concatenate(list(terms.values()))
    jp = np.concatenate([(start[k] + np.argsort(perm[k])).astype(np.int32)
                         for k in terms])
    bm = TD.join_bitmap(terms["hl"], 1 << 21)[None]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    arena = (t(f16), t(flags), t(docids), t(dead))
    jt = (t(jd), t(jp), t(bm))
    print(f"[{args.tag}] set-up {time.time() - t0:.1f} s", flush=True)
    filts = [None, (0x656E, -1, -(2**30), 2**30), (0, 3, -(2**30), 2**30),
             (0, -1, 100, 5000)]
    size = {k: len(d) for k, d in terms.items()}
    p_hl = (jstart["hl"], size["hl"], 0)
    p_jb = (jstart["jB"], size["jB"], -1)
    p_jc = (jstart["jC"], size["jC"], -1)
    shapes = [
        ("solo bitmap jA & hl", ("jA", [p_hl])),
        ("solo sort t1 & jB", ("t1", [p_jb])),
        ("solo sort t1 & jC (2M)", ("t1", [p_jc])),
        ("wave 16 bitmap jA & hl", [("jA", [p_hl], filts[i % 4])
                                    for i in range(16)]),
        ("wave 4 sort t1 & jB", [("t1", [p_jb], filts[i % 4])
                                 for i in range(4)]),
    ]
    out = []
    for label, spec in shapes:
        if label.startswith("solo"):
            k, parts = spec

            def fn(k=k, parts=parts):
                return KD.join_member(*arena, start[k], size[k], *jt, parts,
                                      1)

            def fp(k=k, parts=parts):
                return KD.join_member_plain(*arena, start[k], size[k], *jt,
                                            parts, 1)

            def rows(x):
                return x
        else:
            desc = KD.join_wave_desc([(start[k], size[k], f, p)
                                      for k, p, f in spec], 1, 0)
            off = KD.join_wave_offsets(desc)

            def fn(d=desc, o=off):
                return KD.join_member_batch(*arena, *jt, d, 1, o)

            def fp(d=desc, o=off):
                return KD.join_member_batch_plain(*arena, *jt, d, 1, o)

            def rows(x, d=desc, o=off):
                return KD.wave_rows(x, d, o)
        g, w = fn(), fp()
        torch.cuda.synchronize()
        err = max(float((rows(a).to(torch.int64) - rows(b).to(torch.int64))
                        .abs().max()) for a, b in zip(g, w))
        found = int(rows(w[2]).sum())
        del g, w
        row = {"tag": args.tag, "shape": label, "err": err, "valid": found,
               "ms": KB.call_ms(fn), "device_ms": KB.device_ms(fn),
               "ops": KB.device_ops(fn)}
        print(json.dumps(row), flush=True)
        out.append(row)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(f"[{args.tag}] done {time.time() - t0:.1f} s", flush=True)
    return 0 if all(r["err"] == 0 for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
