"""The port's sharded ranking metrics (debias_vision_lang_torch/metrics/
distributed.py) against the JAX package's on its 8 virtual CPU devices, and
both against the numpy oracle, on the same numpy-seeded inputs: several
top-n, multiclass labels, ragged N (N < 8 included) and boundary ties that
force the per-shard budget to escalate.  The port runs on a CPU mesh of 8
slots.  Bars: 1e-5 between the engines and against the oracle."""

import numpy as np
import pytest
import torch

from debias_vision_lang_torch.metrics import distributed as tdist
from debias_vision_lang_torch.metrics import ranking as tranking
from debias_vision_lang_torch.metrics.oracle import eval_ranking_oracle
from debias_vision_lang_torch.parallel import create_mesh

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    from debias_vision_lang_tpu.parallel.mesh import create_mesh as jcreate

    return jcreate(), create_mesh(devices=CPU8)


def _binary(rng, n, d=8, p=3):
    img = rng.normal(size=(n, d)).astype(np.float32)
    prm = rng.normal(size=(p, d)).astype(np.float32)
    labels = (rng.random(n) < 0.5).astype(np.int32)
    labels[:2] = [0, 1]
    return labels, img, prm


def _three_way(labels, img, prm, evaluation, topn, meshes, atol=1e-5):
    """Port == JAX sharded engine, and each == the oracle."""
    from debias_vision_lang_tpu.metrics.distributed import sharded_eval_ranking

    jmesh, tmesh = meshes
    got = tdist.sharded_eval_ranking(labels, img, prm, evaluation, topn, tmesh)
    want = sharded_eval_ranking(labels, img, prm, evaluation, topn, jmesh)
    oracle = eval_ranking_oracle(labels, img, prm, evaluation, topn)
    assert set(got) == set(want) == set(oracle) == {"eq_opp", "dem_par"}
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=atol), (evaluation, k)
        assert got[k] == pytest.approx(oracle[k], abs=atol), (evaluation, k)
    return got


@pytest.mark.parametrize("topn", [7, 1.0, 0.5])
@pytest.mark.parametrize("evaluation", ["maxskew", "ndkl"])
def test_equivalence_with_jax(meshes, topn, evaluation):
    _three_way(*_binary(np.random.default_rng(0), 64, d=16, p=4), evaluation, topn,
               meshes)


def test_multiclass(meshes):
    rng = np.random.default_rng(1)
    n = 56
    img = rng.normal(size=(n, 8)).astype(np.float32)
    prm = rng.normal(size=(3, 8)).astype(np.float32)
    labels = np.concatenate([np.arange(7), rng.integers(0, 7, n - 7)]).astype(np.int32)
    for evaluation in ("ndkl", "maxskew"):
        _three_way(labels, img, prm, evaluation, 10, meshes)


@pytest.mark.parametrize("n", [30, 61, 7, 3])
def test_ragged_n(meshes, n):
    """N not a multiple of 8, and N < 8 (shards holding only pad rows)."""
    labels, img, prm = _binary(np.random.default_rng(n), n)
    for evaluation in ("maxskew", "ndkl"):
        _three_way(labels, img, prm, evaluation, min(5, n), meshes)


def test_boundary_ties_escalate(meshes, monkeypatch):
    """Every score tied but one: the tie-extended budget overflows on every
    shard and the merge re-runs with the whole shard (32 rows)."""
    n = 256
    img = np.zeros((n, 4), np.float32)
    img[:, 0] = 1.0
    img[5, 0] = 2.0
    prm = np.zeros((2, 4), np.float32)
    prm[:, 0] = 1.0
    labels = (np.arange(n) % 2).astype(np.int32)
    calls = []
    orig = tdist._sharded_metrics
    monkeypatch.setattr(tdist, "_sharded_metrics",
                        lambda *a: calls.append(a[-1]) or orig(*a))
    for evaluation in ("maxskew", "ndkl"):
        _three_way(labels, img, prm, evaluation, 3, meshes)
    assert calls == [3 + tranking.TIE_PAD, 32] * 2  # budget, then the shard


def test_no_escalation_without_boundary_ties(meshes, monkeypatch):
    calls = []
    orig = tdist._sharded_metrics
    monkeypatch.setattr(tdist, "_sharded_metrics",
                        lambda *a: calls.append(a[-1]) or orig(*a))
    labels, img, prm = _binary(np.random.default_rng(2), 400)
    _three_way(labels, img, prm, "ndkl", 5, meshes)
    assert calls == [5 + tranking.TIE_PAD]  # < the 50-row shards: no re-run


def test_ties_across_shard_boundaries_keep_pandas_order(meshes):
    """Few distinct scores: ties straddle every shard boundary, so the merged
    order must be the global row order (pandas ``nlargest``)."""
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 3, 40).astype(np.int32)
    labels[:3] = [0, 1, 2]
    img = np.round(rng.normal(size=(40, 8))).clip(-1, 1).astype(np.float32)
    prm = np.round(rng.normal(size=(6, 8))).clip(-1, 1).astype(np.float32)
    for topn in (1.0, 7, 0.3):
        for evaluation in ("maxskew", "ndkl"):
            _three_way(labels, img, prm, evaluation, topn, meshes)


def test_per_prompt_metrics_equal_the_single_device_engine():
    """sharded_ranking_metrics' [P] vectors against metrics/ranking.py's."""
    labels, img, prm = _binary(np.random.default_rng(5), 45, p=6)
    got = tdist.sharded_ranking_metrics(img, labels, prm, 9, 2, create_mesh(devices=CPU8))
    want = tranking.ranking_metrics(torch.from_numpy(prm @ img.T),
                                    torch.from_numpy(labels).long(), 9, 2)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0)


def test_model_axis_mesh_shards_over_data_only():
    """A (4, 2) mesh splits the rows four ways and gives the same answers."""
    labels, img, prm = _binary(np.random.default_rng(6), 37)
    mesh = create_mesh((4, 2), devices=CPU8)
    for evaluation in ("maxskew", "ndkl"):
        got = tdist.sharded_eval_ranking(labels, img, prm, evaluation, 6, mesh)
        want = tranking.eval_ranking(labels, img, prm, evaluation, 6)
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-6)


def test_default_mesh_follows_the_embeddings_device():
    labels, img, prm = _binary(np.random.default_rng(7), 20)
    got = tdist.sharded_eval_ranking(labels, torch.from_numpy(img), prm, "ndkl", 4)
    want = tranking.eval_ranking(labels, img, prm, "ndkl", 4)
    assert got == pytest.approx(want, abs=1e-6)


def test_bad_evaluation_and_labels_raise():
    labels, img, prm = _binary(np.random.default_rng(8), 16)
    mesh = create_mesh(devices=CPU8)
    with pytest.raises(ValueError, match="maxskew"):
        tdist.sharded_eval_ranking(labels, img, prm, "skew", 4, mesh)
    with pytest.raises(ValueError, match="dense"):
        tdist.sharded_eval_ranking(labels + 1, img, prm, "ndkl", 4, mesh)
