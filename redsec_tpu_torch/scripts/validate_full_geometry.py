"""Full-geometry validation of the schoolbook parameter sets: real-noise
keygen at the reference's ``medium`` (n 3072, N 4096) or ``large`` (n 6144,
N 8192) recipe, or at their repaired ``_v2`` variants, a batch of
bootstraps, decryption, sign correctness and the output noise against the
decode budget.

    python -m redsec_tpu_torch.scripts.validate_full_geometry --set medium --count 32 --seed 0 \\
        [--device cpu] [--engine native]

The PBS runs on ``--device`` (default ``cuda``) through ``prepare_cloud_key``
and ``make_chunked_bootstrap``: one schoolbook round kernel launch a round
(``kernels.schoolbook_round``).  ``--engine native`` runs it on the native CGGI core on the host, the
engine of the JAX package's script.  The inputs are the JAX script's: values
drawn from numpy's ``default_rng(seed + 1)`` in the quarter message space,
the first two pinned to 37 and -414.  Key generation and encryption are
seeded numpy in both packages and a PBS is exact, so the ``RESULT`` dict
(the JAX script's keys) is the same in either for the same seed and count,
``boots_per_s`` aside.
"""

from __future__ import annotations

import argparse
import sys
import time
from math import erfc, sqrt

import numpy as np

SETS = ("medium", "large", "medium_v2", "large_v2")


def validate(p, count: int = 8, seed: int = 0, device: str = "cuda", engine: str = "torch",
             log=print) -> dict:
    """Keygen at ``p``, ``count`` bootstraps, the sign and noise report.

    Returns the ``RESULT`` dict and, beside it, ``keygen_s``, ``prepare_s``,
    ``pbs_s`` and the run's arrays (``ct``, ``out``, ``tv``) under
    ``"arrays"``; with the torch engine also the PBS function under
    ``"pbs"``, so that a caller can run outputs again through another path."""
    from ..crypto import bootstrap as bs
    from ..crypto import keygen as kg
    from ..crypto import lwe
    from .validate_noise_budget import bootstrap_fn, signed_slots

    log(f"params {p.name}: n={p.n} N={p.N} Bg=2^{p.bg_bit} l={p.l} "
        f"ks {p.ks_basebit}x{p.ks_t} msg_space={p.msg_space}")
    t0 = time.perf_counter()
    sk, cloud = kg.keygen(p, seed=seed)
    keygen_s = time.perf_counter() - t0
    log(f"[{keygen_s:7.1f}s] keygen done "
        f"(BK {cloud.bk.nbytes/1e6:.0f} MB, KSK {cloud.ksk.nbytes/1e6:.0f} MB)")
    pbs, prepare_s = bootstrap_fn(cloud, device, engine)
    del cloud
    log(f"[{time.perf_counter()-t0:7.1f}s] {engine} engine key prepared ({prepare_s:.1f}s)")

    rng = np.random.default_rng(seed + 1)
    qspace = p.msg_space // 4
    vals = rng.integers(-qspace, qspace, size=count)
    vals[0], vals[1] = 37, -414  # pin a couple of known points
    ct = lwe.encrypt_integers(sk.lwe_key, vals, p, rng)
    tv = bs.const_test_vector(p, 1, p.msg_space)
    t1 = time.perf_counter()
    out = pbs(ct, tv)
    dt = time.perf_counter() - t1
    where = "the native core" if engine == "native" else device
    log(f"[{time.perf_counter()-t0:7.1f}s] {count} full-n bootstraps in {dt:.1f}s "
        f"({count/dt:.2f}/s on {where})")

    dec = lwe.decrypt_integers(sk.lwe_key, out, p)
    want = np.where(vals >= 0, 1, -1)
    ok = bool((dec == want).all())
    log(f"signs: got {dec.tolist()} want {want.tolist()} -> {'EXACT' if ok else 'MISMATCH'}")
    # the output noise sigma from the signed slot errors, the decode budget
    # in sigma multiples and the implied per-bootstrap flip probability
    # 2 * Phi(-0.5 / sigma)
    sslots = signed_slots(sk.lwe_key, out, want, p)
    slots = np.abs(sslots)
    sig = float(sslots.std(ddof=1)) if count > 1 else float("nan")
    headroom = 0.5 / sig if sig > 0 else float("inf")
    p_flip = erfc(headroom / sqrt(2.0)) if np.isfinite(headroom) else 0.0
    log(f"output noise: max {slots.max():.3f} slots, signed mean {sslots.mean():+.3f}, "
        f"sigma {sig:.4f} (n={count}, rel. err ~{1/np.sqrt(2*(count-1)):.0%})")
    log(f"decode budget 0.5 slots = {headroom:.2f} sigma -> per-bootstrap flip probability "
        f"~{p_flip:.2e}")
    result = {"set": p.name, "count": count, "signs_exact": ok,
              "max_noise_slots": round(float(slots.max()), 4),
              "noise_sigma_slots": round(sig, 4),
              "budget_sigma_multiple": round(headroom, 2),
              "flip_probability": float(f"{p_flip:.3e}"),
              "boots_per_s": round(count / dt, 3)}
    log(f"RESULT {result}")
    return {"result": result, "keygen_s": keygen_s, "prepare_s": prepare_s, "pbs_s": dt,
            "decode_errors": int((dec != want).sum()),
            "arrays": {"ct": ct, "out": out, "tv": tv},
            "pbs": pbs if engine == "torch" else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--set", default="medium", choices=SETS)
    ap.add_argument("--count", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain twins)")
    ap.add_argument("--engine", choices=("torch", "native"), default="torch",
                    help="torch (default): the port's PBS on --device; native: the "
                         "native CGGI core on the host")
    args = ap.parse_args(argv)

    from ..crypto.params import get_params
    from ..device import resolve_device

    if args.engine == "torch":
        resolve_device(args.device)
    return validate(get_params(args.set), args.count, args.seed, args.device, args.engine)


if __name__ == "__main__":
    sys.exit(0 if main()["result"]["signs_exact"] else 2)
