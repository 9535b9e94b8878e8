"""K10 (`rerank_sort`) and K18's probe (`xjoin_probe`) alone on the card,
at the shapes chip_smoke times them and at the edges of their designs:
each result held against the plain version, then (without --check) its
call ms, device ms, device operations and yardstick.

    python -m yacy_search_server_tpu_torch.kernels.k10_k18_bench [--tag T]
        [--check] [--out FILE]
    python -P yacy_search_server_tpu_torch/kernels/k10_k18_bench.py --tree DIR

--tree times the package of another checkout (a parent commit) in place of
this one (-P keeps this file's folder off the import path).
K10's finals are random int32 (a third of a slot's equal), pad lanes
-(2^31-1) as K9 writes them. K18 runs at the smoke's mesh shape, 2,001,217
candidates in a random order against a 10,000,000-entry window over an
arena of 10M rows, on two windows (xjoin_case): "smoke", the odd docids as
in the smoke's headline cell (evenly spaced), and "random" docids."""

import argparse
import json
import sys
import time

import numpy as np
import torch

NEG = -(2 ** 31 - 1)


def rerank_case(rng, ns, nb, pad_final=NEG):
    """(final [bs, nb] int32, qi [bs, 2 + 2nb + 256] int32) with ns[i] live
    lanes a slot: random finals (a third equal), distinct docids below
    2^30, pad lanes' finals `pad_final` and their descriptor docids
    garbage."""
    bs = len(ns)
    qi = np.zeros((bs, 2 + 2 * nb + 256), np.int32)
    fin = np.full((bs, nb), pad_final, np.int32)
    for i, n in enumerate(ns):
        qi[i, 0] = n
        qi[i, 2:2 + nb] = rng.integers(-5, 1 << 30, nb)
        qi[i, 2:2 + n] = rng.choice(1 << 30, n, replace=False)
        f = rng.integers(-(2 ** 31), 2 ** 31 - 1, n, dtype=np.int64)
        f[:n // 3] = f[0] if n else 0
        fin[i, :n] = f.astype(np.int32)
    return fin, qi


def xjoin_case(rng, kind="smoke", n_win=10_000_000, n_cand=2_001_217):
    """The mesh shape's probe inputs as numpy arrays: (cand, dead, jdocids,
    jpos, feats16, flags). "smoke": the window holds the odd docids below
    2 n_win (the smoke's headline cell) and the candidates are odd docids
    below 4 n_win (joinA's in that column): about half are found, the
    others lie past the window's end. "random": the window n_win random
    docids below 4 n_win, half the candidates drawn from it and half past
    its end."""
    if kind == "smoke":
        jd = (2 * np.arange(n_win) + 1).astype(np.int32)
        cand = (2 * rng.choice(2 * n_win, n_cand, replace=False)
                + 1).astype(np.int32)
    else:
        jd = np.sort(rng.choice(4 * n_win, n_win, replace=False)).astype(
            np.int32)
        h = n_cand // 2
        cand = np.concatenate([
            rng.choice(jd, h, replace=False),
            4 * n_win + rng.choice(4 * n_win, n_cand - h, replace=False)])
        cand = rng.permutation(cand).astype(np.int32)
    jp = rng.permutation(n_win).astype(np.int32)
    f16 = rng.integers(0, 3000, (n_win, 17), dtype=np.int16)
    flags = rng.integers(0, 2 ** 30, n_win, dtype=np.int32)
    dead = np.zeros(4 * n_win, bool)
    dead[rng.choice(4 * n_win, 500, replace=False)] = True
    return cand, dead, jd, jp, f16, flags


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="k10k18")
    ap.add_argument("--tree", default=None)
    ap.add_argument("--check", action="store_true",
                    help="hold every shape against its plain version only")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.tree:
        sys.path.insert(0, args.tree)
    from yacy_search_server_tpu_torch.kernels import bench as KB
    from yacy_search_server_tpu_torch.kernels import build as B
    from yacy_search_server_tpu_torch.kernels import dense as KDn
    from yacy_search_server_tpu_torch.kernels import devstore as KD

    t0 = time.time()
    dev = torch.device("cuda")
    B.library()
    rng = np.random.default_rng(14)
    rows, bad = [], []

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def emit(row):
        row["tag"] = args.tag
        print(json.dumps(row), flush=True)
        rows.append(row)

    def err(a, b):
        e = float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
            if a.numel() else 0.0
        return e

    def timed(fn):
        return {"ms": KB.call_ms(fn), "device_ms": KB.device_ms(fn)}

    # -- K10 ---------------------------------------------------------------
    k10 = [("16 slots nb=16", [16, 3, 0, 13] * 4, 16),
           ("16 slots nb=128", [128, 100, 1, 77, 0, 5, 64, 99] * 2, 128),
           ("16 slots nb=1024", [1024, 1000, 0, 513] * 4, 1024),
           ("1 slot nb=128", [100], 128),
           ("2 slots nb=16384", [16384, 16384], 16384),
           ("serving solo nb=16384, one live of 9000",
            [9000] + [0] * 15, 16384),
           ("serving solo nb=16384, one live of 16384",
            [16384] + [0] * 15, 16384)]
    k10 += [(f"2 slots nb={nb}", [nb, nb], nb) for nb in (2048, 4096, 8192)]
    k10 += [(f"16 full slots nb={nb}", [nb] * 16, nb)
            for nb in (256, 512, 1024, 2048)]
    if args.check:
        for nb in [1 << s for s in range(4, 15)]:
            for bs in (1, 2, 16, 20):
                ns = [int(x) for x in rng.integers(0, nb + 1, bs)]
                ns[0] = nb
                k10.append((f"check bs={bs} nb={nb}", ns, nb))
            k10.append((f"check nb={nb}, n_valid 0, 1, nb/2+1, nb",
                        [0, 1, nb // 2 + 1, nb], nb))
    for label, ns, nb in k10:
        for pad in ((NEG, 7) if args.check else (NEG,)):
            fin_np, qi = rerank_case(rng, ns, nb, pad)
            if args.check and pad == NEG and len(ns) > 1 and ns[1] > 1:
                # a live lane that ties a pad key, finals that wrap
                qi[1, 2] = 2 ** 31 - 1
                fin_np[1, 0] = NEG
                fin_np[1, 1] = -(2 ** 31)
            fin, qd = t(fin_np), t(qi)
            want = KDn.rerank_sort_plain(fin, qd, nb)
            e = err(KDn.rerank_sort(fin, qd, nb), want)
            row = {"kernel": "rerank_sort", "shape": label, "err": e,
                   "pad_final": pad}
            if e:
                bad.append(label)
            if not args.check:
                row.update(timed(lambda: KDn.rerank_sort(fin, qd, nb)))
                row["ops"] = KB.device_ops(lambda: KDn.rerank_sort(fin, qd,
                                                                   nb))
                key = (KDn._wrap32(-fin.to(torch.int64)).to(torch.int64)
                       * 2 ** 32 + qd[:, 2:2 + nb].to(torch.int64) + 2 ** 31)
                row["library"] = timed(
                    lambda: torch.sort(key, dim=1, stable=True))
            emit(row)
    print(f"[{args.tag}] K10 done {time.time() - t0:.1f} s", flush=True)

    # -- K18's probe ----------------------------------------------------------
    X = {}

    def probe(c, lo, cnt):
        return KD.xjoin_probe(c, X["dead"], None, 1, X["jd"], X["jp"], lo,
                              cnt, X["f16"], X["flags"])

    def probe_plain(c, lo, cnt):
        return KD.xjoin_probe_plain(c, X["dead"], None, 1, X["jd"], X["jp"],
                                    lo, cnt, X["f16"], X["flags"])

    for kind in ("smoke", "random"):
        X.clear()
        cand, X["dead"], X["jd"], X["jp"], X["f16"], X["flags"] = (
            t(a) for a in xjoin_case(rng, kind))
        n_win = X["jd"].shape[0]
        k18 = [(f"mesh shape ({kind}): 2,001,217 candidates, 10M-entry "
                "window", cand, 0, n_win)]
        if args.check and kind == "smoke":
            # windows around whole staging (up to 252 entries in 256 words)
            # and the fence strides (2^s entries a fence, 256 fences at
            # most); docids around the window's (2 lo + 1 .. 2 (lo + cnt) -
            # 1), its first and last entries among them
            for lo, cnt in ((5, 0), (5, 1), (0, 252), (0, 253), (3, 512),
                            (3, 513), (0, 4_091), (0, 4_092),
                            (0, 4_093), (3, 8_192), (3, 8_193),
                            (0, 32_767), (0, 32_768), (3, 32_769),
                            (1, 65_536), (1, 65_537), (7, 1_000_000),
                            (0, n_win)):
                c = rng.integers(max(0, 2 * lo - 2), 2 * (lo + cnt) + 2,
                                 100_000).astype(np.int32)
                c[:2] = (2 * lo + 1, 2 * (lo + cnt) - 1)
                k18.append((f"check window ({lo}, {cnt})", t(c), lo, cnt))
        for label, c, lo, cnt in k18:
            want = probe_plain(c, lo, cnt)
            row = {"kernel": "xjoin_probe", "shape": label,
                   "err": err(probe(c, lo, cnt), want),
                   "err again": err(probe(c, lo, cnt), want),
                   "found": int(want[0].sum())}
            if row["err"] or row["err again"]:
                bad.append(label)
            if not args.check:
                row.update(timed(lambda: probe(c, lo, cnt)))
                row["ops"] = KB.device_ops(lambda: probe(c, lo, cnt))
                win = X["jd"][lo:lo + cnt]
                jpw = X["jp"][lo:lo + cnt]

                def lib_fn():
                    i = torch.searchsorted(win, c).clamp_(max=cnt - 1)
                    return jpw[i], win[i] == c
                row["library"] = timed(lib_fn)
            emit(row)
    if args.check:
        # valid candidates at and above 2^29 (only the last matches the
        # window's 2^29), twice in a row: the counters reset
        jdh = t(np.append(2 * np.arange(5000) + 1, 2 ** 29).astype(np.int32))
        jph = t(rng.permutation(5001).astype(np.int32))
        ch = rng.choice(10_000, 3000, replace=False).astype(np.int32)
        ch[[5, 900, 2999]] = [2 ** 29 + 3, 2 ** 29, 2 ** 30 + 1]
        ch = t(ch)
        want = KD.xjoin_probe_plain(ch, X["dead"], None, 1, jdh, jph, 0,
                                    5001, X["f16"], X["flags"])
        es = [err(KD.xjoin_probe(ch, X["dead"], None, 1, jdh, jph, 0, 5001,
                                 X["f16"], X["flags"]), want)
              for _ in range(2)]
        row = {"kernel": "xjoin_probe", "shape": "check rows >= 2^29",
               "err": max(es), "found": int(want[0].sum()),
               "last found": int(want[0, 2999])}
        if row["err"] or row["last found"] != 1 or int(want[0, 900]):
            bad.append(row["shape"])
        emit(row)
    print(f"[{args.tag}] K18 done {time.time() - t0:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    if bad:
        print(f"[{args.tag}] DISAGREE: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
