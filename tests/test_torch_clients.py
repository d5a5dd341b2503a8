"""The port's client plumbing (`repro_torch.fed.clients`) against the JAX
package's `repro.fed.clients`.

Every comparison here is bit for bit, with no tolerance: the counter
PRNG's uniforms (integer words, then an exact power-of-two scale), the
attendance masks of all three kinds with the round index as an int and
as a 0-dim int32 tensor (the round state's), the static flags and
transmit multipliers, the realized history, and the pool's accounting
(integer counts and their exact float32 fractions).
"""
import numpy as np
import pytest
import torch

from repro.data import PARTITIONERS as J_PARTITIONERS
from repro.fed import clients as jcl
from repro_torch.data import PARTITIONERS, synthetic_mnist
from repro_torch.fed import (PARTICIPATION_KINDS, ClientPool,
                             ParticipationSchedule, counter_uniform,
                             make_pool)

torch.set_num_threads(1)

# seeds without and with a high word
SEEDS = [0, 17, 0xFFFFFFFF, (1 << 32) + 5, (0xDEADBEEF << 32) | 0x1234]
ROUNDS = [0, 1, 2 ** 31 - 1]


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    return got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("t", ROUNDS)
def test_counter_uniform_bitwise(seed, t):
    for n in (1, 7, 20, 130):
        want = jcl.counter_uniform(seed, t, n)
        assert _same(counter_uniform(seed, t, n), want), n
        t_dev = torch.tensor(t, dtype=torch.int32)
        assert _same(counter_uniform(seed, t_dev, n), want), n


@pytest.mark.parametrize("kind", PARTICIPATION_KINDS)
@pytest.mark.parametrize("rate", [0.0, 0.4, 0.5, 1.0])
def test_present_bitwise(kind, rate):
    kw = dict(kind=kind, rate=rate, seed=5, straggler_every=3,
              straggler_frac=0.4)
    js, ts = jcl.ParticipationSchedule(**kw), ParticipationSchedule(**kw)
    for C, M in ((2, 3), (4, 5)):
        for t in list(range(7)) + [2 ** 31 - 1]:
            want = js.present(t, C, M)
            assert _same(ts.present(t, C, M), want), (C, M, t)
            got = ts.present(torch.tensor(t, dtype=torch.int32), C, M)
            assert _same(got, want), (C, M, t)
    if kind == "bernoulli" and rate == 1.0:
        # 24-bit uniforms are < 1: everyone attends
        assert bool((ts.present(3, 4, 5) == 1.0).all())


@pytest.mark.parametrize("nb,nf,M", [(0, 0, 5), (1, 0, 5), (3, 1, 5),
                                     (4, 3, 5), (7, 2, 5), (2, 9, 3)])
@pytest.mark.parametrize("scale", [2.0, 3.0])
def test_flags_and_tx_base_bitwise(nb, nf, M, scale):
    kw = dict(n_byzantine=nb, n_free_riders=nf, byzantine_scale=scale)
    js, ts = jcl.ParticipationSchedule(**kw), ParticipationSchedule(**kw)
    for want, got in zip(js.flags(3, M), ts.flags(3, M)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    want, got = js.tx_base(3, M), ts.tx_base(3, M)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert ts.is_full == js.is_full == (nb == 0 and nf == 0)


@pytest.mark.parametrize("kind", PARTICIPATION_KINDS)
def test_history_and_attendance_fraction_bitwise(kind):
    kw = dict(kind=kind, rate=0.6, seed=11, straggler_every=2,
              straggler_frac=0.5)
    js, ts = jcl.ParticipationSchedule(**kw), ParticipationSchedule(**kw)
    want = js.history(9, 3, 4)
    got = ts.history(9, 3, 4)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for t in range(9):
        assert _same(ts.attendance_fraction(t, 3, 4),
                     js.attendance_fraction(t, 3, 4))


@pytest.mark.parametrize("kw", [dict(kind="nope"), dict(rate=1.5),
                                dict(rate=-0.1), dict(straggler_every=0),
                                dict(n_byzantine=-1),
                                dict(n_free_riders=-2)])
def test_schedule_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        jcl.ParticipationSchedule(**kw)
    with pytest.raises(ValueError) as got:
        ParticipationSchedule(**kw)
    assert str(got.value) == str(want.value)


def test_participation_kinds_match_reference():
    assert PARTICIPATION_KINDS == jcl.PARTICIPATION_KINDS


def test_client_pool_accounting_bitwise():
    (xtr, ytr), _ = synthetic_mnist(0, n_train=240, n_test=10)
    for name in ("iid", "noniid", "cluster-noniid"):
        jp = jcl.make_pool(J_PARTITIONERS[name], 3, xtr, ytr, 2, 3)
        tp = make_pool(PARTITIONERS[name], 3, xtr, ytr, 2, 3)
        assert isinstance(tp, ClientPool)
        assert (tp.C, tp.M) == (jp.C, jp.M) == (2, 3)
        assert tp.X.tobytes() == jp.X.tobytes()
        hist_t, hist_j = tp.label_histogram(), jp.label_histogram()
        assert hist_t.dtype == hist_j.dtype
        assert hist_t.tobytes() == hist_j.tobytes()
        assert tp.label_histogram(4).tobytes() == jp.label_histogram(
            4).tobytes()
        assert (tp.attendance_fractions().tobytes()
                == jp.attendance_fractions().tobytes())
        sched = dict(kind="bernoulli", rate=0.5, seed=2)
        hist = ParticipationSchedule(**sched).history(7, 2, 3)
        tp.mark_round()
        jp.mark_round()
        for t in range(7):
            tp.mark_round(hist[t])
            jp.mark_round(jcl.ParticipationSchedule(**sched).history(
                7, 2, 3)[t])
        assert tp.rounds_seen == jp.rounds_seen == 8
        assert (tp.attendance_fractions().tobytes()
                == jp.attendance_fractions().tobytes())
        for c in range(2):
            for m in range(3):
                a, b = tp.client(c, m), jp.client(c, m)
                assert (a.cluster, a.index, a.n_samples,
                        a.rounds_participated) == (
                    b.cluster, b.index, b.n_samples,
                    b.rounds_participated)
                assert a.rounds_participated == 1 + int(hist[:, c, m].sum())
        with pytest.raises(ValueError, match="mask shape"):
            tp.mark_round(np.ones((3, 2)))
