"""Per-source validation of ``utils/noise_budget.py``: measure each bootstrap
output-noise source in isolation, by zeroing the others, and compare it with
the analytic prediction.

Isolation levers (all exact, no engine changes):
- alpha_bk=0 / alpha_ks=0 keygen variants zero the key-sample terms;
- l*bg_bit >= 32 zeroes the gadget-truncation term;
- ks_t*ks_basebit >= 32 zeroes the key-switch truncation term;
- sweeping ks_t at fixed everything-else scales only the key-switch
  truncation term (x4 variance predicted per dropped basebit*level bit-pair).

    python -m redsec_tpu_torch.scripts.validate_noise_budget --quick --count 96 --seed 0 \\
        [--device cpu] [--engine native]

One line per experiment: predicted against measured sigma (slots), the
signed mean, the decode errors and PASS/FAIL at 3 combined sigmas; the last
line is ``RESULT {...}``, as the JAX package's script prints them.  The PBS
runs on ``--device`` (default ``cuda``) through ``prepare_cloud_key`` and
``make_chunked_bootstrap``: the blind-rotation kernel (K4) at every small
experiment, the schoolbook-product kernel (S1) at ``medium`` and ``large``.
``--engine native`` runs it on the native CGGI core (``native/``) instead,
the engine of the JAX package's script.  Key generation and encryption are
seeded numpy in both packages and a PBS is exact, so the same seed and count
give the same numbers in either.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

ENGINES = ("torch", "native")


def experiments(quick: bool) -> list:
    """(label, params, note) of each experiment, in the JAX script's order."""
    from ..crypto.params import PARAM_SETS

    sv2 = PARAM_SETS["small_v2"]
    R = dataclasses.replace
    out = [
        ("sv2/total", sv2, "all sources (production set)"),
        ("sv2/bk-only", R(sv2, name="x1", alpha_ks=0.0, ks_basebit=4, ks_t=8, alpha_enc=0.0),
         "alpha_ks=0, 32-bit KS precision -> BK noise + gadget only"),
        ("sv2/ks-trunc18", R(sv2, name="x2", alpha_bk=0.0, alpha_ks=0.0, alpha_enc=0.0,
                             ks_basebit=3, ks_t=6),
         "all alphas 0, KS precision 18 bits -> pure KS truncation"),
        ("sv2/ks-trunc21", R(sv2, name="x3", alpha_bk=0.0, alpha_ks=0.0, alpha_enc=0.0,
                             ks_basebit=3, ks_t=7),
         "21-bit KS precision: predicted sigma/8 of 18-bit"),
        ("sv2/gadget21", R(sv2, name="x4", alpha_bk=0.0, alpha_ks=0.0, alpha_enc=0.0,
                           bg_bit=3, l=7, ks_basebit=4, ks_t=8),
         "all alphas 0, 32-bit KS, 21-bit gadget -> pure gadget truncation"),
        ("sv2/ks-noise", R(sv2, name="x5", alpha_bk=0.0, alpha_enc=0.0, ks_basebit=4, ks_t=8),
         "alpha_bk=0, 32-bit KS precision -> pure KS key noise (alpha_ks=2^-25)"),
        ("tpu2/total", PARAM_SETS["small_v2_tpu2"], "widest-base shipped set"),
    ]
    if not quick:
        out += [("medium/total", PARAM_SETS["medium"], "reference medium recipe"),
                ("large/total", PARAM_SETS["large"], "reference large recipe")]
    return out


def capped_count(p, count: int) -> int:
    """The bootstraps an experiment runs: ``count``, capped at 64 for
    ``medium``'s n and 48 for ``large``'s."""
    if p.n >= 3000:
        return min(count, 64 if p.n < 5000 else 48)
    return count


def passes(sig: float, pred: float, n: int) -> bool:
    """Measured within 3 combined sigmas of predicted (the sampling error of
    a std estimate is about sigma / sqrt(2 (n - 1)))."""
    rel = 1 / np.sqrt(2 * (n - 1))
    return abs(sig - pred) <= 3 * rel * max(sig, pred) if pred > 0 else sig < 1e-3


def bootstrap_fn(cloud, device: str, engine: str):
    """-> (``pbs(ct, testvect) -> numpy int32``, seconds to prepare the key).
    ``engine="torch"``: the key prepared on ``device``, the PBS through
    ``make_chunked_bootstrap``; ``"native"``: the native core."""
    t0 = time.perf_counter()
    if engine == "native":
        from .. import native

        eng = native.NativeEngine(cloud)
        return eng.bootstrap, time.perf_counter() - t0
    if engine != "torch":
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    from ..crypto import bootstrap as bs

    dkey = bs.prepare_cloud_key(cloud, device=device)
    run = bs.make_chunked_bootstrap(dkey)
    if dkey.device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    return (lambda ct, tv: run(ct, tv).cpu().numpy()), time.perf_counter() - t0


def signed_slots(key: np.ndarray, out: np.ndarray, want: np.ndarray, p) -> np.ndarray:
    """Each output's phase distance from ``want * mu``, in message slots."""
    from ..crypto import lwe

    mu = int(lwe.mod_switch_to_torus32(np.array([1]), p.msg_space)[0])
    phase = lwe.lwe_phase(key, out).astype(np.int64)
    serr = (phase - want * mu).astype(np.int32).astype(np.float64)
    return serr / (2**32 / p.msg_space)


def measure(p, count: int, seed: int = 0, device: str = "cuda", engine: str = "torch"):
    """Keygen and PBS of ``count`` quarter-space values (zeros made 1)
    through a sign test vector; -> (sigma_slots, mean_slots,
    n_decode_errors, PBS seconds)."""
    from ..crypto import bootstrap as bs
    from ..crypto import keygen as kg
    from ..crypto import lwe

    sk, cloud = kg.keygen(p, seed=seed)
    pbs, _ = bootstrap_fn(cloud, device, engine)
    rng = np.random.default_rng(seed + 1)
    qspace = p.msg_space // 4
    vals = rng.integers(-qspace, qspace, size=count)
    vals[vals == 0] = 1
    ct = lwe.encrypt_integers(sk.lwe_key, vals, p, rng)
    tv = bs.const_test_vector(p, 1, p.msg_space)
    t0 = time.perf_counter()
    out = pbs(ct, tv)
    dt = time.perf_counter() - t0
    dec = lwe.decrypt_integers(sk.lwe_key, out, p)
    want = np.where(vals >= 0, 1, -1)
    slots = signed_slots(sk.lwe_key, out, want, p)
    return (float(slots.std(ddof=1)), float(slots.mean()), int((dec != want).sum()), dt)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--count", type=int, default=256)
    ap.add_argument("--quick", action="store_true",
                    help="skip the (slow) full medium/large geometries")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain twins)")
    ap.add_argument("--engine", choices=ENGINES, default="torch",
                    help="torch (default): the port's PBS on --device; native: the "
                         "native CGGI core on the host")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..utils.noise_budget import budget

    if args.engine == "torch":
        resolve_device(args.device)
    print(f"count={args.count}  (sigma rel. err ~{1/np.sqrt(2*(args.count-1)):.1%} per "
          f"experiment)")
    hdr = (f"{'experiment':16} {'pred σ':>8} {'meas σ':>8} {'ratio':>6} "
           f"{'mean':>7} {'errs':>5} {'verdict':>8}")
    print(hdr + "\n" + "-" * len(hdr))
    rows = []
    for label, p, note in experiments(args.quick):
        n = capped_count(p, args.count)
        pred = budget(p).sigma_slots()
        sig, mean, errs, dt = measure(p, n, args.seed, args.device, args.engine)
        ratio = sig / pred if pred > 0 else float("inf")
        ok = passes(sig, pred, n)
        rows.append({"label": label, "params": p.name, "count": n, "pred": pred, "sigma": sig,
                     "mean": mean, "errors": errs, "pbs_s": dt, "ok": bool(ok)})
        print(f"{label:16} {pred:8.4f} {sig:8.4f} {ratio:6.2f} "
              f"{mean:+7.3f} {errs:5d} {'PASS' if ok else 'FAIL':>8}"
              f"   [{note}; {n} boots in {dt:.1f}s]", flush=True)
    result = {"experiments": len(rows), "pass": sum(r["ok"] for r in rows),
              "fail": [r["label"] for r in rows if not r["ok"]]}
    print("RESULT", result, flush=True)
    return {"rows": rows, "result": result}


if __name__ == "__main__":
    sys.exit(0 if not main()["result"]["fail"] else 2)
