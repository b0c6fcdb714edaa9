"""PyTorch port, serving operating points (``evaluation/operating_points.py``)
and the exit plots (``evaluation/plots.py``) against the JAX package's
functions on the same numpy store, labels and seed: equal outputs (the
same float64 numpy arithmetic on both sides), and ``plot_exits`` the same
files with the same pixels."""

import numpy as np
import pytest

from multi_modal_early_exit_tpu.config.exit_config import ExitConfig as JExitConfig
from multi_modal_early_exit_tpu.evaluation import operating_points as JOP
from multi_modal_early_exit_tpu.evaluation import plots as JPL
from multi_modal_early_exit_tpu_torch.config.exit_config import ExitConfig
from multi_modal_early_exit_tpu_torch.evaluation import operating_points as TOP
from multi_modal_early_exit_tpu_torch.evaluation import plots as TPL


def _store(seed, e=4, n=400, k=6):
    """An (E+1, N, K) store whose deeper exits are sharper, and labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, n)
    store = rng.standard_normal((e, n, k))
    for i in range(e):
        store[i, np.arange(n), labels] += 0.8 * (i + 1) * rng.random(n)
    return store, labels


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _same(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_sweep_thresholds_and_dead_exits_match_jax():
    store, labels = _store(0)
    grid = np.round(np.arange(0.1, 1.0, 0.1), 4)
    _same(TOP.sweep_thresholds(store, labels, grid), JOP.sweep_thresholds(store, labels, grid))
    _same(TOP._sweep(store, labels, grid), JOP._sweep(store, labels, grid))
    dist = {0: 0.005, 1: 0.3, 2: 0.0, 3: 0.695}
    assert TOP.dead_exits_of(dist, 3) == JOP.dead_exits_of(dist, 3) == [0, 2]


@pytest.mark.parametrize("z", [0.0, 1.28])
def test_paired_drop_ucb_matches_jax(z):
    rng = np.random.default_rng(1)
    cand, full = rng.random(300) < 0.7, rng.random(300) < 0.75
    assert TOP.paired_drop_ucb(cand, full, z) == JOP.paired_drop_ucb(cand, full, z)


@pytest.mark.parametrize("seed", [0, 3])
def test_select_operating_points_matches_jax(seed):
    store, labels = _store(seed)
    kw = dict(n_emb=2, n_stages=3, batch=16)
    want = [p.to_dict() for p in JOP.select_operating_points(store, labels, **kw)]
    got = [p.to_dict() for p in TOP.select_operating_points(store, labels, **kw)]
    _same(got, want)
    # a budget nothing meets: full depth, in both
    want = [p.to_dict() for p in JOP.select_operating_points(
        store, labels, accuracy_drops=(("never", -1.0),), **kw)]
    got = [p.to_dict() for p in TOP.select_operating_points(
        store, labels, accuracy_drops=(("never", -1.0),), **kw)]
    _same(got, want)


def test_select_mixture_operating_point_matches_jax():
    store, labels = _store(5, n=600)
    kw = dict(n_emb=2, n_stages=3, batch=16, accuracy_drop=0.02, num_mixtures=20_000,
              num_per_exit=12, seed=7)
    want = JOP.select_mixture_operating_point(store, labels, **kw)
    got = TOP.select_mixture_operating_point(store, labels, **kw)
    assert (got is None) == (want is None)
    if want is not None:
        _same(got.to_dict(), want.to_dict())


def test_prune_dead_exits_matches_jax():
    for exits, dist in ((("text_avg", "vision_avg", 3, 7), {0: 0.0, 1: 0.2, 2: 0.001, 3: 0.5}),
                        (("text_avg", 1), {0: 0.0, 1: 0.0})):
        j_cfg, j_dead = JOP.prune_dead_exits(JExitConfig(exits=exits), dist)
        t_cfg, t_dead = TOP.prune_dead_exits(ExitConfig(exits=exits), dist)
        assert t_dead == j_dead
        assert t_cfg.to_dict() == j_cfg.to_dict()


def test_plot_exits_writes_the_same_images(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    store, labels = _store(2, e=3, n=30, k=4)
    rng = np.random.default_rng(9)
    pixels = rng.uniform(-1, 1, (30, 3, 16, 16)).astype(np.float32)
    exits = rng.integers(0, 3, 30)
    exits[exits == 1] = 2  # exit 1 never fires: no file for it
    names = {0: "letter", 1: "form", 2: "email", 3: "memo"}
    want = JPL.plot_exits(store, labels, exits, pixels, id2label=names,
                          out_dir=str(tmp_path / "jax"))
    got = TPL.plot_exits(store, labels, exits, pixels, id2label=names,
                         out_dir=str(tmp_path / "port"))
    assert got.keys() == want.keys() and 1 not in got
    for e in want:
        np.testing.assert_array_equal(np.asarray(Image.open(got[e])),
                                      np.asarray(Image.open(want[e])))
    np.testing.assert_array_equal(TPL._denormalize(pixels[0]), JPL._denormalize(pixels[0]))
