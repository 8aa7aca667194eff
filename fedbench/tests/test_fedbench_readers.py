"""The trace reduction and each per-layer metric's reader on a small
recorded window: kernel names as the card's profiler gives them, times as
a qwen2-0.5b.aircomp.walk-heavy round spends them, scaled down."""
import json
import os

import pytest

from fb_helpers import ROOT

US = 1000   # ns
# (name, start_ns, duration_ns, is_kernel): two rounds, each a walk, a
# GEMM, an RMSNorm, an attention, a replay, the norms and the AirComp
# reduce, one host-to-device copy; a 50 us gap in round 0
WALK = "void (anonymous namespace)::zo_walk_kernel<0>(float const*, float*)"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x128x8_stage3"
NORM = "void (anonymous namespace)::rmsnorm_kernel<float, float>(...)"
FLASH = "void (anonymous namespace)::flash_fwd_f32<64, 64>(float const*)"
REPLAY = "void (anonymous namespace)::zo_replay_kernel<0>(float const*)"
DIRN = "void (anonymous namespace)::dirnorm_kernel<0>(long long const*)"
AIR = "void (anonymous namespace)::aircomp_reduce_kernel<4>(float const*)"
COPY = "Memcpy HtoD (Pageable -> Device)"


def recorded():
    ev, t = [], 0
    for r in range(2):
        for name, dur in ((COPY, 2), (DIRN, 100), (WALK, 300), (GEMM, 200),
                          (NORM, 10), (FLASH, 20), (REPLAY, 150), (AIR, 40)):
            ev.append((name, t * US, dur * US, name != COPY))
            t += dur
            if r == 0 and name == GEMM:
                t += 50                      # the device idles 50 us
    return ev, t * US


def window(total_ns, family="dense", cfg_name="qwen2-0.5b",
           traffic="aircomp.walk-heavy"):
    from fedbench import cell as fcell
    from fedbench import devtrace
    ev, _ = recorded()
    with open(os.path.join(ROOT, "fedbench", "configs",
                           f"{cfg_name}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "fedbench", "traffic",
                           f"{traffic}.json")) as f:
        tr = json.load(f)
    busy = devtrace.merged([(t, t + d) for _, t, d, _ in ev])
    w = devtrace.Window(
        kernels=[(n, t, d) for n, t, d, k in ev if k],
        busy_s=sum(b - a for a, b in busy) / 1e9, window_s=total_ns / 1e9,
        rounds=2, family=fcell.family_module(family), cfg=cfg, traffic=tr)
    return w, ev, busy


def read(name, w):
    from fedbench import cell as fcell
    return fcell.reader(name)(w)


def test_merged_and_breakdown():
    from fedbench import devtrace
    ev, total = recorded()
    w, _, busy = window(total)
    assert len(busy) == 2                   # the gap splits the intervals
    assert w.busy_s == pytest.approx((total - 50 * US) / 1e9)
    host = [("fedbench.round", 0, total), ("aten::item", 600 * US, 660 * US)]
    b = devtrace.breakdown(ev, busy, host, (0, total))
    assert b["device_ops"][0] == [WALK, 600e-6]
    assert b["idle_gaps"] == [["aten::item", 50e-6]]
    assert devtrace.merged([(0, 5), (3, 9), (10, 12)]) == [[0, 9], [10, 12]]


def test_readers():
    from fedbench import counts
    ev, total = recorded()
    w, _, _ = window(total)
    assert read("device_idle_share", w) == pytest.approx(
        100 * 50 / (total / US))
    assert read("launches_per_round", w) == 7
    zo_ns = 2 * (100 + 300 + 150 + 40) * US
    assert read("zo_ms_per_round", w) == pytest.approx(zo_ns / 1e6 / 2)
    assert read("model_ms_per_round", w) == pytest.approx(230 * US / 1e6)
    d = counts.param_count(w.family, w.cfg)
    assert read("zo_roofline", w) == pytest.approx(
        100 * 2 * counts.zo_bound_s(w.traffic, d) / (zo_ns / 1e9))
    assert read("lm_kernel_roofline", w) == pytest.approx(
        100 * 2 * counts.lm_kernel_bound_s(w.family, w.cfg, w.traffic)
        / (2 * 30 * US / 1e9))
    assert read("round_mfu", w) == pytest.approx(
        100 * 2 * counts.flops_per_round(w.family, w.cfg, w.traffic)
        / (total / 1e9 * 67e12))


def test_reader_finds_nothing():
    """A reader that finds nothing to read returns None, never 0."""
    from fedbench import devtrace
    ev, total = recorded()
    w, _, _ = window(total)
    w.kernels = [k for k in w.kernels if "rmsnorm" not in k[0]
                 and "flash" not in k[0]]
    assert read("lm_kernel_roofline", w) is None
    empty = devtrace.Window(kernels=[], busy_s=0.0, window_s=1.0, rounds=2,
                            family=w.family, cfg=w.cfg, traffic=w.traffic)
    for name in ("zo_roofline", "zo_ms_per_round", "model_ms_per_round",
                 "launches_per_round", "device_idle_share"):
        assert read(name, empty) is None


def test_events_of_a_host_profile():
    """The profiler's own events: the window span found, host ops kept."""
    import torch
    from fedbench import devtrace
    with devtrace.profiler() as prof:
        with torch.profiler.record_function(devtrace.WINDOW_SPAN):
            torch.ones(64) @ torch.ones(64)
    dev, host, span = devtrace.events(prof)
    assert span is not None and span[1] > span[0]
    assert any(name.startswith("aten::") for name, _, _ in host)
