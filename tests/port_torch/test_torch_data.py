"""The port's data modules are copies of the reference's: byte-equal arrays
for the same seeds (tolerance: none — ``np.testing.assert_array_equal``)."""
import importlib

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

# the packages re-export the split functions under the modules' names
jdigits = importlib.import_module("repro.data.digits")
jsplit = importlib.import_module("repro.data.federated_split")
tdigits = importlib.import_module("repro_torch.data.digits")
tsplit = importlib.import_module("repro_torch.data.federated_split")


@pytest.mark.parametrize("n,seed,probs", [(0, 0, None), (37, 3, None),
                                          (64, 11, [3, 1, 1, 1, 1, 1, 1, 1,
                                                    1, 2])])
def test_make_digit_dataset_byte_equal(n, seed, probs):
    a = jdigits.make_digit_dataset(n, seed=seed, class_probs=probs)
    b = tdigits.make_digit_dataset(n, seed=seed, class_probs=probs)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.images.dtype == b.images.dtype and a.labels.dtype == b.labels.dtype


def _pairs(ds_j, ds_t, split_j, split_t, **kw):
    for sj, st in zip(split_j(ds_j, **kw), split_t(ds_t, **kw), strict=True):
        np.testing.assert_array_equal(sj.images, st.images)
        np.testing.assert_array_equal(sj.labels, st.labels)


@pytest.mark.parametrize("num_devices,seed,unbalance", [(1, 0, 0.3),
                                                        (4, 1, 0.3),
                                                        (9, 2, 1.5),
                                                        (60, 3, 0.3)])
def test_federated_split_byte_equal(num_devices, seed, unbalance):
    ds_j = jdigits.make_digit_dataset(120, seed=seed)
    ds_t = tdigits.make_digit_dataset(120, seed=seed)
    _pairs(ds_j, ds_t, jsplit.federated_split, tsplit.federated_split,
           num_devices=num_devices, seed=seed, unbalance=unbalance)


@pytest.mark.parametrize("num_devices,alpha", [(3, 0.5), (8, 0.1)])
def test_dirichlet_split_byte_equal(num_devices, alpha):
    ds_j = jdigits.make_digit_dataset(90, seed=4)
    ds_t = tdigits.make_digit_dataset(90, seed=4)
    _pairs(ds_j, ds_t, jsplit.dirichlet_split, tsplit.dirichlet_split,
           num_devices=num_devices, alpha=alpha, seed=7)


@pytest.mark.parametrize("seed", range(4))
def test_partition_sizes_equal(seed):
    rng = np.random.default_rng(seed)
    raw = np.maximum(1.0 + rng.uniform(-1.5, 1.5, size=12), 0.05)
    n = int(rng.integers(12, 200))
    np.testing.assert_array_equal(jsplit._partition_sizes(raw, n),
                                  tsplit._partition_sizes(raw, n))


def test_split_validation_matches():
    ds = tdigits.make_digit_dataset(5, seed=0)
    with pytest.raises(ValueError):
        tsplit.federated_split(ds, 6)
    with pytest.raises(ValueError):
        tsplit.federated_split(ds, 0)
