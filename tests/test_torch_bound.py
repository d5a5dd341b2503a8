"""Queue A item 12 without the benchmark tools: the convergence bound
(`repro_torch.core.bound`), `WHFLTrainer` and the quickstart, against
the JAX package.

The bound is numpy float64 on both sides with the same operations, so
each of the paper's Fig. 4 curves (``benchmarks/fig4_bound.py``'s
settings: the MNIST i.i.d. setting, C 4, M 5, K = K' = 100, 2N = 7850,
400 rounds; W-HFL at I = 1, 2, 4, conventional OTA FL, the error-free
baseline) and the Corollary 2 closed form equal the reference's bit for
bit.  `WHFLTrainer` is held to the JAX one round by round on the
quickstart's setting within the port's end-to-end bounds (loss-free:
the model within 1e-4 of max |theta|, the average edge power within
rtol 1e-5), and ``examples/quickstart_torch.py`` prints the JAX
quickstart's lines.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bound as j_bound
from repro.core import random_topology as j_random_topology
from repro.core.whfl import WHFLConfig as JWHFLConfig
from repro.core.whfl import WHFLTrainer as JWHFLTrainer
from repro.core.channel import OTAConfig as JOTAConfig
from repro.core.topology import uniform_topology as j_uniform_topology
from repro.data import partition_iid, synthetic_mnist
from repro.models.paper_models import mnist_apply as j_mnist_apply
from repro.models.paper_models import mnist_init as j_mnist_init
from repro.nn.core import split_params
from repro.optim import sgd as j_sgd
from repro_torch import convert, prng
from repro_torch.core import OTAConfig, bound, random_topology
from repro_torch.core.topology import uniform_topology
from repro_torch.core.whfl import WHFLConfig, WHFLTrainer
from repro_torch.optim import sgd

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 400


def _fig4(mod, topo_fn):
    """benchmarks/fig4_bound.py's curves through module `mod`."""
    topo = topo_fn(0, C=4, M=5, K=100, K_ps=100, sigma_z2=10.0)
    bp = mod.BoundParams(L=10.0, mu=1.0, G2=1.0, Gamma=1.0, two_n=7850,
                         tau=1, I=1)
    curves = {
        "whfl": mod.theorem1_curve(topo, bp, T),
        "conventional": mod.conventional_curve(topo, bp, T),
        "error-free": mod.theorem1_curve(topo, bp, T, channel="error-free"),
        "corollary2": mod.corollary2_curve(topo, bp, T, eta=1e-2),
    }
    for I in (2, 4):
        curves[f"whfl-I{I}"] = mod.theorem1_curve(
            topo, dataclasses.replace(bp, I=I), T // I)
    return topo, curves


def test_fig4_curves_equal_reference_bitwise():
    t_topo, mine = _fig4(bound, random_topology)
    j_topo, ref = _fig4(j_bound, j_random_topology)
    assert sorted(mine) == sorted(ref)
    for name in ref:
        assert mine[name].dtype == np.float64
        assert mine[name].tobytes() == np.asarray(ref[name]).tobytes(), name
    # the paper's ordering claims hold on the port's curves
    assert mine["whfl"][-1] < mine["conventional"][-1]
    assert (mine["error-free"] <= mine["whfl"] + 1e-9).all()
    # the degenerate single-hop topology, field by field
    ct, jt = (bound.conventional_topology(t_topo),
              j_bound.conventional_topology(j_topo))
    for f in ("C", "M", "K", "K_ps", "sigma_z2", "sigma_h2"):
        assert getattr(ct, f) == getattr(jt, f), f
    for f in ("d_mu_is", "d_is_ps", "d_mu_ps"):
        np.testing.assert_array_equal(np.asarray(getattr(ct, f)),
                                      np.asarray(getattr(jt, f)))
    assert (bound.corollary2_Y(bound.BoundParams(), t_topo, 1e-2, 1.5)
            == j_bound.corollary2_Y(j_bound.BoundParams(), j_topo, 1e-2,
                                    1.5))


def _loss_t(params, x, y, rng):
    logits = x @ params["w"] + params["b"]
    onehot = (y[..., None] == torch.arange(10)).to(logits.dtype)
    return -torch.mean(torch.sum(torch.log_softmax(logits, -1) * onehot, -1))


def _loss_j(params, x, y, rng):
    logits = j_mnist_apply(params, x)
    onehot = jax.nn.one_hot(y, 10)
    return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))


@pytest.mark.parametrize("mode", ["whfl", "conventional"])
def test_trainer_matches_reference(mode):
    C, M, rounds = 2, 3, 4
    (xtr, ytr), _ = synthetic_mnist(0, n_train=1200, n_test=10)
    X, Y = partition_iid(0, xtr, ytr, C, M)
    kw = dict(C=C, M=M, K=16, K_ps=16, sigma_z2=1.0, d_cluster=2.5)
    j_cfg = JWHFLConfig(tau=1, I=1, batch=32, mode=mode,
                        ota=JOTAConfig(mode="equivalent"))
    t_cfg = WHFLConfig(tau=1, I=1, batch=32, mode=mode,
                       ota=OTAConfig(mode="equivalent"))
    jt = JWHFLTrainer(_loss_j, j_sgd(0.1), j_uniform_topology(**kw), j_cfg,
                      X, Y)
    tt = WHFLTrainer(_loss_t, sgd(0.1), uniform_topology(**kw), t_cfg, X, Y,
                     device="cpu")
    jp = split_params(j_mnist_init(jax.random.PRNGKey(0)))[0]
    js = jt.init_state(jp)
    ts = tt.init_state(convert.params_from_jax(jax.device_get(jp)))
    jk, tk = jax.random.PRNGKey(1), prng.PRNGKey(1, "cpu")
    for _ in range(rounds):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        js = jt.round(js, jsub)
        ts = tt.round(ts, tsub)
    assert int(ts["t"]) == int(js["t"]) == rounds
    for leaf in ("w", "b"):
        want = np.asarray(js["theta"][leaf])
        gap = np.abs(ts["theta"][leaf].numpy() - want).max()
        assert gap <= 1e-4 * np.abs(want).max(), leaf
    np.testing.assert_allclose(tt.avg_edge_power(ts),
                               jt.avg_edge_power(js), rtol=1e-5)
    np.testing.assert_allclose(tt.avg_is_power(ts), jt.avg_is_power(js),
                               rtol=1e-5)


def test_trainer_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        WHFLTrainer(_loss_t, sgd(0.1), uniform_topology(C=1, M=1),
                    WHFLConfig(), np.zeros((1, 1, 2, 784), np.float32),
                    np.zeros((1, 1, 2), np.int32))


def test_quickstart_prints_the_reference_lines():
    """Both quickstarts, 25 rounds of each mode: the same accuracy (3
    decimals) and average edge power (3 digits)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"),
               JAX_PLATFORMS="cpu")
    run = lambda *a: subprocess.run(
        [sys.executable, *a], env=env, capture_output=True, text=True,
        timeout=600, cwd=_REPO)
    mine = run("examples/quickstart_torch.py", "--device", "cpu")
    ref = run("examples/quickstart.py")
    assert mine.returncode == 0, mine.stderr
    assert ref.returncode == 0, ref.stderr
    lines = mine.stdout.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["W-HFL", "conventional"]
    assert lines == ref.stdout.strip().splitlines()
