"""PyTorch port, the data layer: the synthetic suites and their stacking,
the schedulers' observation models, the budget cut-offs, the metric
transforms, LCBench-format artifacts and the source registry, each equal
(``np.array_equal``, or the same floats) to the reference's for the same
seeds and files."""
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.data as ref_data
import repro_torch.data as data

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "lcbench_mini.npz"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes are tiny, and the suite's parallel
    workers would otherwise oversubscribe the cores with spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_tasks(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert type(x).__name__ == type(y).__name__ == "CurveTask"
        for f in x._fields:
            assert np.array_equal(getattr(x, f), getattr(y, f)), f


@pytest.mark.parametrize("kw", [dict(), dict(crossing=True, n=6, m=9, d=5),
                                dict(noise=0.03, diverge_prob=0.5, n=5, m=8)])
def test_sample_suite_equals_reference(kw):
    _same_tasks(data.sample_suite(4, 3, **kw), ref_data.sample_suite(4, 3, **kw))


@pytest.mark.parametrize("pad", [False, True])
def test_stack_suite_equals_reference(pad):
    """An aligned suite (shared 1-D t), and a ragged one padded to the max
    shape with its grids extended by their own last step."""
    if pad:
        tasks = [data.sample_task(1, n=5, m=6, d=4),
                 data.sample_task(2, n=7, m=4, d=4,
                                  t=np.array([1.0, 2.0, 4.0, 8.0]))]
    else:
        tasks = data.sample_suite(2, 3, n=5, m=6, d=4)
    got = data.stack_suite(tasks, pad=pad)
    want = ref_data.stack_suite(tasks, pad=pad)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert got[1].ndim == (2 if pad else 1)


def test_stack_suite_errors_match_reference():
    tasks = [data.sample_task(1, n=5, m=6, d=4),
             data.sample_task(2, n=7, m=6, d=4)]
    other_d = [data.sample_task(1, n=5, m=6, d=4),
               data.sample_task(2, n=5, m=6, d=5)]
    for bad in ([], tasks, other_d):
        msgs = []
        for mod in (data, ref_data):
            with pytest.raises(ValueError) as e:
                mod.stack_suite(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_noisy_step_fns_equal_reference():
    task = data.sample_task(5, n=4, m=10, d=4)
    got = data.noisy_step_fns(task, seed=3, obs_noise=0.05, spike_prob=0.3)
    want = ref_data.noisy_step_fns(task, seed=3, obs_noise=0.05,
                                   spike_prob=0.3)
    seq = [(i, e) for e in range(6) for i in (2, 0, 3, 1)]
    assert [got[i]() for i, _ in seq] == [want[i]() for i, _ in seq]


@pytest.mark.parametrize("censored", [None, True, False])
def test_replay_step_fns_equal_reference(censored):
    """A loaded (partly censored) artifact task replayed past its cut-offs,
    with and without an added noise model."""
    task = data.load_artifact(FIXTURE).tasks[2]
    for noise in (0.0, 0.02):
        got = data.replay_step_fns(task, seed=1, obs_noise=noise,
                                   spike_prob=noise, censored=censored)
        want = ref_data.replay_step_fns(task, seed=1, obs_noise=noise,
                                        spike_prob=noise, censored=censored)
        for i in range(4):
            assert [got[i]() for _ in range(14)] == \
                [want[i]() for _ in range(14)]


def test_replay_of_a_config_with_nothing_recorded_raises():
    task = data.sample_task(0, n=3, m=5, d=4)
    task = task._replace(mask=task.mask * np.array([[1.0], [0.0], [1.0]]))
    task = task._replace(Y_full=task.Y_full * task.mask)
    for mod in (data, ref_data):
        fns = mod.replay_step_fns(task, censored=True)
        with pytest.raises(RuntimeError, match="config 1 is censored"):
            fns[1]()


@pytest.mark.parametrize("budget", [0, 17, 40, 200])
def test_benchmark_cutoffs_equal_reference(budget):
    """ifBO-style cut-offs, including a budget past the grid (clamped with
    the same warning)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = data.benchmark_cutoffs(budget, 8, 5, seed=2)
        want = ref_data.benchmark_cutoffs(budget, 8, 5, seed=2)
    assert np.array_equal(got, want) and got.dtype == want.dtype
    assert int(got.sum()) == min(budget, 40)
    assert len(caught) == (2 if budget > 40 else 0)


def test_metric_transforms_equal_reference():
    """Sign flip, per-task affine normalisation, the progression warp and
    their composition: the same numbers forward, inverse and for variances;
    they also act on torch tensors."""
    rng = np.random.default_rng(0)
    Y = rng.uniform(0.2, 2.0, (5, 6))
    mask = (rng.random((5, 6)) < 0.7).astype(np.float64)
    for maximize in (True, False):
        for normalize in (False, True):
            got = data.metric_transform(maximize, normalize, Y, mask)
            want = ref_data.metric_transform(maximize, normalize, Y, mask)
            assert got == want
            for fn in ("__call__", "inverse", "inverse_var"):
                assert np.array_equal(getattr(got, fn)(Y),
                                      getattr(want, fn)(Y))
            torch.testing.assert_close(got(torch.from_numpy(Y)),
                                       torch.from_numpy(want(Y)), rtol=0,
                                       atol=0)
    with pytest.raises(ValueError, match="needs Y and mask"):
        data.metric_transform(normalize=True)
    warp, rwarp = data.LogWarp(1.0), ref_data.LogWarp(1.0)
    t = np.arange(0.0, 9.0)
    assert np.array_equal(warp(t), rwarp(t))
    assert np.array_equal(warp.inverse(warp(t)), rwarp.inverse(rwarp(t)))
    assert data.AffineTransform.identity() == ref_data.AffineTransform.identity()
    assert data.AffineTransform.sign(False) == (-1.0, 0.0)


def test_lcbench_fixture_loads_the_same_in_both_packages():
    """The committed 3-task fixture (24/24/20 configs x 12 epochs, the third
    censored): identical tasks, names, metric, convention and has_full."""
    got, want = data.load_artifact(FIXTURE), ref_data.load_artifact(FIXTURE)
    _same_tasks(got.tasks, want.tasks)
    assert [t.X.shape for t in got.tasks] == [(24, 7), (24, 7), (20, 7)]
    assert [t.t.shape for t in got.tasks] == [(12,)] * 3
    assert (got.names, got.metric, got.maximize, got.has_full, got.meta) == \
        (want.names, want.metric, want.maximize, want.has_full, want.meta)
    assert got.has_full == [True, True, False]


def test_artifacts_round_trip_across_packages(tmp_path):
    """An artifact written by the port loads in the reference to the same
    tasks and metadata, and the other way round; bad inputs raise the same
    errors."""
    tasks = data.sample_suite(3, 2, n=4, m=5, d=4)
    ours = data.write_artifact(tmp_path / "a.npz", tasks, metric="loss",
                               maximize=False, extra_meta={"k": 1})
    theirs = ref_data.write_artifact(tmp_path / "b.npz", tasks,
                                     metric="loss", maximize=False,
                                     extra_meta={"k": 1})
    assert (tmp_path / "a.npz").read_bytes() == (tmp_path / "b.npz").read_bytes()
    for path in (ours, theirs):
        a, b = data.load_artifact(path), ref_data.load_artifact(path)
        _same_tasks(a.tasks, b.tasks)
        assert a.meta == b.meta and a.maximize is False
    bad = tasks[0]._replace(t=tasks[0].t[::-1].copy())
    for mod in (data, ref_data):
        with pytest.raises(ValueError, match="strictly"):
            mod.write_artifact(tmp_path / "c.npz", [bad])
        with pytest.raises(ValueError, match="at least one task"):
            mod.write_artifact(tmp_path / "c.npz", [])


def test_sources_equal_reference():
    """The registry: synthetic variants sample the reference's suites, the
    lcbench source reads the fixture, unknown kinds and variants raise."""
    assert data.list_source_kinds() == ref_data.list_source_kinds()
    for spec in ("synthetic", "synthetic:crossing", "synthetic:noisy-divergent"):
        src, ref = data.get_source(spec), ref_data.get_source(spec)
        assert (src.spec, src.dataset_id, src.maximize) == \
            (ref.spec, ref.dataset_id, ref.maximize)
        assert isinstance(src, data.CurveSource)
        _same_tasks(src.tasks(2, seed=4, n=5, m=6, d=4),
                    ref.tasks(2, seed=4, n=5, m=6, d=4))
    spec = f"lcbench:{FIXTURE}"
    src, ref = data.get_source(spec), ref_data.get_source(spec)
    assert isinstance(src, data.LCBenchSource)
    assert (src.dataset_id, src.names, src.has_full, src.maximize) == \
        (ref.dataset_id, ref.names, ref.has_full, ref.maximize)
    _same_tasks(src.tasks(2), ref.tasks(2))
    assert len(data.get_source(f"ifbo:{FIXTURE}").tasks()) == 3
    for bad in ("nope:x", "synthetic:wild", "lcbench"):
        msgs = []
        for mod in (data, ref_data):
            with pytest.raises(ValueError) as e:
                mod.get_source(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_stacked_fixture_fits_and_serves_through_the_batched_path():
    """The fixture's ragged tasks, padded by stack_suite and fitted by the
    port's fit_batch (polish): finite final-value predictions per task, the
    padded rows included, from posterior_batch."""
    from repro_torch.core import LKGPConfig, fit_batch, posterior_batch
    X, t, Y, mask, _ = data.stack_suite(
        data.get_source(f"lcbench:{FIXTURE}").tasks(), pad=True)
    assert X.shape == (3, 24, 7) and t.shape == (3, 12)
    st = fit_batch(X, t, Y, mask, LKGPConfig(), polish_steps=1,
                   device="cpu")
    mean, var = posterior_batch(st, device="cpu").final()
    assert mean.shape == var.shape == (3, 24)
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())
