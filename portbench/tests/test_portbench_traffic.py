import numpy as np
import pytest

from portbench import generate, harness

MIXES = ["train_recipe", "decode_batch"]


def _mix(name):
    return harness.load_json(harness.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_batches(name):
    mix = dict(_mix(name), pool=2, t_envelope=1280)
    a = generate.make_batches(mix, 8, 40, 24, 2**31 + 17)
    b = generate.make_batches(mix, 8, 40, 24, 2**31 + 17)
    c = generate.make_batches(mix, 8, 40, 24, 2**31 + 18)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["x"], c[0]["x"])


@pytest.mark.parametrize("name", MIXES)
def test_lengths_days_labels_in_range(name):
    mix = dict(_mix(name), pool=3)
    for b in generate.make_batches(mix, 4, 40, 24, 99):
        lens = b["x_lens"]
        assert b["x"].shape == (mix["batch"], mix["t_envelope"], 4)
        assert lens.min() >= mix["t_min"] and lens.max() <= mix["t_max"]
        assert b["days"].min() >= 0 and b["days"].max() < 24
        # the bins past each trial's length are zero, the rest drawn
        for i, n in enumerate(lens):
            assert not b["x"][i, n:].any() and b["x"][i, :n].std() > 0.5
        if "u_envelope" in mix:
            y, yl = b["y"], b["y_lens"]
            assert yl.min() >= mix["u_min"] and yl.max() <= mix["u_max"]
            for i, n in enumerate(yl):
                assert y[i, :n].min() >= 1 and y[i, :n].max() <= 40 and not y[i, n:].any()


def test_every_seed_asks_for_the_same_work():
    mix = _mix("train_recipe")
    mix = dict(mix, pool=2)
    a = generate.make_batches(mix, 2, 40, 24, 1)
    b = generate.make_batches(mix, 2, 40, 24, 7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.sort(x["x_lens"]), np.sort(y["x_lens"]))
        np.testing.assert_array_equal(np.sort(x["y_lens"]), np.sort(y["y_lens"]))
    assert not np.array_equal(a[0]["x_lens"], b[0]["x_lens"])
    lens = np.sort(a[0]["x_lens"])
    assert lens[0] >= 400 and lens[-1] <= 1200 and abs(lens.mean() - 800) < 10


def test_a_mix_missing_a_parameter_is_refused():
    with pytest.raises(ValueError):
        generate.check_mix({"kind": "train", "batch": 4})
    with pytest.raises(ValueError):
        generate.check_mix({"kind": "train", "batch": 4, "t_min": 10, "t_max": 200,
                            "t_envelope": 100, "pool": 1})
