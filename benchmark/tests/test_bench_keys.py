"""The keygen on the device: the shapes and dtypes of the port's CloudKey, one
seed one key, the port's PBS under these keys decrypting to the right signs;
on the card, the medium_v2 key accepted by prepare_cloud_key with its
a-priori rounding bound."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import keys
from redsec_tpu_torch.crypto.bootstrap import (const_test_vector, make_batched_bootstrap,
                                               prepare_cloud_key)
from redsec_tpu_torch.crypto.keygen import CloudKey
from redsec_tpu_torch.crypto.params import MEDIUM_V2, SMALL_V2_TPU, TfheParams


def _dict(p: TfheParams) -> dict:
    return dataclasses.asdict(p)


def test_shapes_and_determinism():
    p = _dict(dataclasses.replace(SMALL_V2_TPU, n=5))
    a = keys.keygen(p, keys.generator(2**31 + 9, "cpu"), "cpu")
    b = keys.keygen(p, keys.generator(2**31 + 9, "cpu"), "cpu")
    assert a["bk"].shape == (5, 12, 2, 1024) and a["ksk"].shape == (1024, 9, 6)
    assert a["lwe_key"].shape == (5,) and a["rlwe_key"].shape == (1024,)
    for x in a:
        assert a[x].dtype == np.int32 and np.array_equal(a[x], b[x])
    assert set(np.unique(a["lwe_key"])) <= {0, 1}
    c = keys.keygen(p, keys.generator(2**31 + 10, "cpu"), "cpu")
    assert not np.array_equal(a["bk"], c["bk"])


def test_bootstrapping_key_is_tgsw_of_the_secret():
    """Each BK row decrypts under the RLWE key to s_i times the gadget."""
    p = _dict(dataclasses.replace(SMALL_V2_TPU, n=3))
    k = keys.keygen(p, keys.generator(4, "cpu"), "cpu")
    a = torch.as_tensor(k["bk"][:, :, 0].reshape(-1, 1024))
    body = torch.as_tensor(k["bk"][:, :, 1].reshape(-1, 1024)).to(torch.int64)
    phase = (body - keys.negacyclic_binary(a, torch.as_tensor(k["rlwe_key"], dtype=torch.int64)
                                           ).to(torch.int64)).reshape(3, 12, 1024)
    phase = ((phase + 2**31) % 2**32) - 2**31
    s = torch.as_tensor(k["lwe_key"], dtype=torch.int64)
    K = torch.as_tensor(k["rlwe_key"], dtype=torch.int64)
    noise = phase.clone()
    for j in range(6):  # gadget h_j = 2^(32 - 5 (j + 1)): row j adds s_i h_j to a, row 6 + j to b
        h = 1 << (27 - 5 * j)
        noise[:, j] += (s * h)[:, None] * K[None, :]
        noise[:, 6 + j, 0] -= s * h
    noise = ((noise + 2**31) % 2**32) - 2**31
    assert noise.abs().max() < 2**32 * 2.0**-30 * 8  # 8 sigma of alpha_bk


@pytest.mark.parametrize("n", [6])
def test_port_pbs_decrypts_to_the_signs(n):
    P = dataclasses.replace(SMALL_V2_TPU, n=n)
    p = _dict(P)
    g = keys.generator(21, "cpu")
    k = keys.keygen(p, g, "cpu")
    values = np.array([-900, -300, -5, 7, 250, 1100] * 4)
    ct = keys.encrypt(values, k["lwe_key"], p, g, "cpu")
    dkey = prepare_cloud_key(CloudKey(P, k["bk"], k["ksk"]), "cpu")
    out = make_batched_bootstrap(dkey)(ct, const_test_vector(P, 64, P.msg_space))
    got = keys.decrypt(out.numpy(), k["lwe_key"], P.msg_space)
    assert np.array_equal(np.sign(got), np.sign(values)) and set(np.abs(got)) == {64}


@pytest.mark.cuda
def test_medium_v2_key_prepared_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from redsec_tpu_torch.crypto import kernels

    k = keys.keygen(_dict(MEDIUM_V2), keys.generator(2**31 + 3, "cuda"), "cuda")
    dkey = prepare_cloud_key(CloudKey(MEDIUM_V2, k["bk"], k["ksk"]), "cuda")
    bound = kernels.schoolbook_key_bound(dkey.bk, MEDIUM_V2)
    print(f"medium_v2 key: a-priori rounding bound {bound:.6g}")
    assert dkey.ntt_flavor == "schoolbook" and bound < 0.5
