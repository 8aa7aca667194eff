"""The plain reference against the port at the -smoke sizes on the CPU,
and a whole run of each cell at that size: correct when sound, not
correct with the timed path broken underneath."""
import pytest
import torch

from fb_helpers import CELLS, smoke_cell

SEED = 2 ** 31 + 77


def test_directions_and_splits_match_the_port():
    from repro_torch.kernels.zo_axpy import counter_gen
    from repro_torch.utils import prng
    from fedbench.reference import threefry
    k0, k1 = 0x9E3779B9, 0x7F4A7C15
    idx = torch.arange(70_001, dtype=torch.int64)
    for n in (0, 1, 19):
        got = threefry.direction(k0, k1, n, 70_001, device="cpu",
                                 chunk=4096)
        want = counter_gen("normal", torch.tensor(k0), torch.tensor(k1), n,
                           idx)
        assert torch.equal(got, want)
    key = torch.tensor([k0, k1], dtype=torch.int64)
    assert prng.split(key, 7).tolist() == \
        [list(p) for p in threefry.split(k0, k1, 7)]


def test_channel_mask_matches_the_port():
    from repro_torch.core.aircomp import schedule_by_channel
    from repro_torch.utils import prng
    from fedbench.reference import keys
    rng = torch.Generator().manual_seed(3)
    for _ in range(40):
        key = torch.randint(0, 2 ** 32, (2,), generator=rng,
                            dtype=torch.int64)
        mask, noise = keys.channel(key.tolist(), 6, 0.8)
        ks = prng.split(key, 2)
        _, want = schedule_by_channel(ks[0], 6, 0.8)
        assert torch.equal(mask, want)
        assert list(noise) == ks[1].tolist()


@pytest.mark.parametrize("name", CELLS)
def test_reference_loss_matches_the_port(name):
    from repro_torch.models import api
    from fedbench import harness, inputs
    c = smoke_cell(name)
    model = api.build(harness.model_config(c.cfg))
    w = inputs.Weights(c.family, c.cfg, SEED, "cpu")
    tok, lab = inputs.token_pool(c.traffic, c.cfg["vocab"], SEED, "cpu")
    for m in range(c.traffic["clients"]):
        batch = {"tokens": tok[0, m, 0], "labels": lab[0, m, 0]}
        want = float(model.loss(w.tree, batch))
        got = float(c.family.loss(w.tree, c.cfg, batch["tokens"],
                                  batch["labels"]))
        assert abs(got - want) <= 1e-6 * abs(want)


def run(name, fault=None):
    from fedbench import check, harness, readings
    c = smoke_cell(name)
    make = {"unchanged": _unchanged, **readings.RUNS}[fault or "sound"]
    out = harness.run(c, SEED, 0.0, 0, device="cpu",
                      round_fn=make and make(c))
    ok, checks = check.judge(check.readings(c, SEED, out, "cpu"), c.limits)
    return ok and out.failed == 0, checks


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    ok, checks = run(name)
    assert ok, checks


def _unchanged(cell):
    """A round that returns the server weights unchanged."""
    from repro_torch.core import fedzo

    def round_fn(loss, params, *args, **kw):
        _, met = fedzo.round_simulated(loss, params, *args, **kw)
        return params, met
    return round_fn


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "token"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_round_is_not_correct(name, fault):
    ok, checks = run(name, fault)
    assert not ok, checks
