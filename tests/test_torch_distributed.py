"""Multi-process training of the port on the CPU over Gloo (the
counterpart of tests/test_distributed.py and test_parallel.py:48-131,
234-248): ranks of tests/torch_mesh_worker.py train the two-output model
of tests/test_parallel.py on a probe mesh (2 ranks), with the
data-sharded exact objective (2 ranks), on a 'grid'-only mesh (2 ranks)
and on probe_grid_mesh(2, 2) (4 ranks), against the single-process run;
the ranks end with the same bits, and the single-process port run
matches the JAX package's meshless run on the same probe stream."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import runlmc_tpu as R
import torch_mesh_worker as W
from runlmc_tpu.lmc import likelihood as jlk

PROBE_STEPS, EXACT_STEPS, GRID_ONLY_STEPS, PG_STEPS = 12, 8, 4, 8


def _inputs():
    """tests/test_parallel.py's data (its ``rng`` fixture's seed 0), the
    JAX model's initial parameters, and its probe stream for the next
    ``optimize`` (JAX folds the global iteration into that run key)."""
    rng = np.random.default_rng(0)
    n = 40
    Xs = [np.sort(rng.uniform(0, 2 * np.pi, (n, 1)), axis=0)
          for _ in range(2)]
    Ys = [np.sin(X[:, 0]) + 0.05 * rng.standard_normal(n) for X in Xs]
    inp = {"x0": Xs[0], "x1": Xs[1], "y0": Ys[0], "y1": Ys[1]}
    mj = R.InterpolatedLLGP(Xs, Ys, functional_kernel=W.sincos_spec(R),
                            m=[16], seed=1, trace_iterations=16,
                            tolerance=1e-11, objective="stochastic")
    inp["p0"] = np.array(mj.param_array)
    _, run_key = jax.random.split(mj._key)
    # a chunk runs 10 steps whatever the stop: two chunks' worth
    for it in range(20):
        inp["probes%d" % it] = np.array(jlk.rademacher_probes(
            jax.random.fold_in(run_key, it), 16, 2 * n, jnp.float64))
    return inp, mj


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, the JAX model, the two-rank and four-rank results,
    and the single-process port runs of the same cases."""
    inp, mj = _inputs()
    tmp = tmp_path_factory.mktemp("mesh_train")
    two = W.spawn("train2", 2, inp, tmp)
    four = W.spawn("train4", 4, inp, tmp)
    one = {}
    W.train(one, "probe", W.sincos(inp, None, tolerance=1e-11,
                                   objective="stochastic"), PROBE_STEPS)
    W.train(one, "exact", W.sincos(inp, None, objective="exact"),
            EXACT_STEPS, predict=True)
    fft = dict(tolerance=1e-11, objective="stochastic", grid_mode="fft")
    W.train(one, "gridonly", W.sincos(inp, None, **fft), GRID_ONLY_STEPS,
            predict=True)
    W.train(one, "pg", W.sincos(inp, None, **fft), PG_STEPS, predict=True)
    return inp, mj, two, four, one


def _close_to(ranks, one, name, rtol, atol):
    """The ranks' parameters and per-step gradient norms against one
    rank: AdaDelta's step is nearly blind to the gradient's scale, so
    the norms are what a gradient off by the world size would break."""
    np.testing.assert_allclose(ranks[0][name + "_params"],
                               one[name + "_params"], rtol=rtol, atol=atol)
    np.testing.assert_allclose(ranks[0][name + "_grad_norms"],
                               one[name + "_grad_norms"], rtol=rtol)


def _same_bits(ranks, name):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name + "_params"],
                                      ranks[0][name + "_params"])
        np.testing.assert_array_equal(r[name + "_grad_norms"],
                                      ranks[0][name + "_grad_norms"])


def test_probe_mesh_training_matches_one_rank(runs):
    """The stochastic solve batch (17 rows) over 2 ranks at tolerance
    1e-11: a layout change, not a numerical one."""
    _, _, two, _, one = runs
    assert int(two[0]["world"]) == 2
    _same_bits(two, "probe")
    assert int(two[0]["probe_n_iter"]) == int(one["probe_n_iter"]) \
        == PROBE_STEPS
    _close_to(two, one, "probe", 1e-6, 1e-8)


def test_one_rank_matches_jax_on_the_same_probe_stream(runs):
    """The single-process port run against the JAX package's meshless run
    from the same parameters, on JAX's probe stream."""
    _, mj, _, _, one = runs
    info = mj.optimize(optimizer=R.AdaDelta(max_it=PROBE_STEPS))
    assert int(info["n_iter"]) == int(one["probe_n_iter"])
    np.testing.assert_allclose(one["probe_params"], mj.param_array,
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(one["probe_grad_norms"], info["grad_norms"],
                               rtol=1e-6)


def test_data_sharded_exact_objective_matches_one_rank(runs):
    """80 data rows over 2 ranks, float32 factors: only the float32 sums'
    order moves (JAX's own bound, test_parallel.py:106-131); a predict on
    the mesh model."""
    _, _, two, _, one = runs
    _same_bits(two, "exact")
    assert str(two[0]["exact_objective"]) == "exact"
    assert int(two[0]["exact_n_iter"]) == int(one["exact_n_iter"])
    _close_to(two, one, "exact", 5e-3, 1e-4)
    for r in two:
        assert np.all(np.isfinite(r["exact_mu"]))
        assert np.all(r["exact_var"] >= 0)
    np.testing.assert_array_equal(two[0]["exact_mu"], two[1]["exact_mu"])


def test_mesh_reports_and_checkpoints_run_replicated(runs):
    """The reports of the mesh models (the exact and the Woodbury
    log-likelihood of the data-sharded one; the SLQ log-likelihood
    through the grid-sharded fft operator) are the meshless model's at
    the same parameters, the same on every rank; a mesh model's
    checkpoint restores into a meshless model."""
    inp, _, two, _, _ = runs
    for r in two:
        np.testing.assert_array_equal(r["exact_ll"], two[0]["exact_ll"])
        np.testing.assert_array_equal(r["gridonly_ll"], two[0]["gridonly_ll"])
        np.testing.assert_array_equal(r["exact_restored"], r["exact_params"])
    # the same calls as the ranks made (the predict's solve leaves the
    # alpha the quadratic term reads)
    m = W.sincos(inp, None, objective="exact")
    m.param_array = two[0]["exact_params"]
    m.predict([W.inp_test(m)] * 2)
    np.testing.assert_allclose(
        two[0]["exact_ll"], [m.log_likelihood(), m.log_likelihood(exact=False)],
        rtol=1e-12)
    g = W.sincos(inp, None, tolerance=1e-11, objective="stochastic",
                 grid_mode="fft")
    g.param_array = two[0]["gridonly_params"]
    g.predict([W.inp_test(g)] * 2)
    np.testing.assert_allclose(two[0]["gridonly_ll"],
                               g.log_likelihood(exact=False), rtol=1e-10)


def test_grid_only_mesh_has_no_rhs_sharding(runs):
    """A mesh whose only axis is 'grid' shards the fft group's Fourier
    axis and not the solve batch (test_parallel.py:234-248)."""
    _, _, two, _, one = runs
    assert all(bool(r["gridonly_rhs_sharding"]) for r in two)
    _same_bits(two, "gridonly")
    assert int(two[0]["gridonly_n_iter"]) == GRID_ONLY_STEPS
    _close_to(two, one, "gridonly", 1e-6, 1e-8)
    np.testing.assert_allclose(two[0]["gridonly_mu"], one["gridonly_mu"],
                               rtol=1e-6, atol=1e-8)
    assert np.all(two[0]["gridonly_var"] >= 0)


def test_probe_grid_mesh_training_matches_one_rank(runs):
    """probe_grid_mesh(2, 2) on 4 ranks: the solve batch over 'probe',
    the fft group's Fourier axis over 'grid' (test_parallel.py:71-103);
    a predict on the mesh model."""
    _, _, _, four, one = runs
    assert [int(r["world"]) for r in four] == [4] * 4
    _same_bits(four, "pg")
    assert int(four[0]["pg_n_iter"]) == int(one["pg_n_iter"]) == PG_STEPS
    _close_to(four, one, "pg", 1e-6, 1e-8)
    for r in four:
        assert np.all(np.isfinite(r["pg_mu"]))
        np.testing.assert_array_equal(r["pg_mu"], four[0]["pg_mu"])
    np.testing.assert_allclose(four[0]["pg_mu"], one["pg_mu"], rtol=1e-6,
                               atol=1e-8)
