"""The system under test: the PyTorch/CUDA port ``redsec_tpu_torch``.

The only module of the benchmark that imports the program.  It hands the
program what a server of encrypted inference receives (the model's weights
file, the evaluation key as int32 arrays, the parameter set's numbers) and
takes back the program's encrypted forward and its launch counters.
"""

from __future__ import annotations

import os


def build(cfg: dict, root: str, keys: dict, device: str):
    """The port's encrypted forward, int32 [B, H, W, C, n+1] -> [B, classes,
    n+1] on ``device``, for the configuration's model, weights and parameter
    set, under the evaluation key ``keys`` ("bk", "ksk"), prepared by the
    program as after loading a key file (``run-encrypted``)."""
    from redsec_tpu_torch.crypto.bootstrap import prepare_cloud_key
    from redsec_tpu_torch.crypto.keygen import CloudKey
    from redsec_tpu_torch.crypto.params import TfheParams
    from redsec_tpu_torch.models.spec import prep_model
    from redsec_tpu_torch.models.zoo import get_model
    from redsec_tpu_torch.runtime.encrypted import build_encrypted_forward

    params = TfheParams(**cfg["params"])
    plan = prep_model(get_model(cfg["model"]), os.path.join(root, cfg["weights"]))
    dkey = prepare_cloud_key(CloudKey(params, keys["bk"], keys["ksk"]), device)
    return build_encrypted_forward(plan, dkey)


def launch_counts() -> dict:
    """The program's kernel launch counters (``device.launches``), by kernel."""
    from redsec_tpu_torch.device import launches

    return dict(launches.counts)
