"""The yardstick's counts against reckonings made by hand at the
configuration's published shapes."""
import json
import os

import pytest

from fb_helpers import ROOT


def cfg(name):
    with open(os.path.join(ROOT, "fedbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def traffic(name):
    with open(os.path.join(ROOT, "fedbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


def test_qwen2_counts():
    from fedbench import counts
    from fedbench.models import dense
    c = cfg("qwen2-0.5b")
    layer = (896 * 896 + 2 * 896 * 128 + 896 * 896 + 3 * 896 * 4864
             + 896 + 2 * 128 + 2 * 896)
    assert counts.param_count(dense, c) == 24 * layer + 151936 * 896 + 896 \
        == 494_032_768 == c["params"]
    assert counts.n_pad(494_032_768) == 494_075_904
    assert dense.matmul_params(c) == 24 * 14_909_440 + 136_134_656 \
        == 493_961_216
    # q.k and p.v over 64 * 65 / 2 causal pairs, 14 heads of 64, 24 layers
    assert dense.attention_flops(c, 64) == 4 * 64 * 14 * 24 * 2080 \
        == 178_913_280
    assert dense.forward_flops(c, 64) == 2 * 493_961_216 * 64 + 178_913_280


def test_zo_bound_walk_heavy():
    """Cell 1's ZO kernels a round: every term int32-bound but the AirComp
    reduction (bytes); 71 operations a Threefry evaluation."""
    from fedbench import counts
    t = traffic("aircomp.walk-heavy")
    d, n, M = 494_032_768, 494_075_904, 4
    ops = 16.75e12
    norms = 71 * M * 20 * d / ops
    first = 71 * M * n / ops
    later = 71 * 2 * M * n / ops
    replay = 71 * 20 * M * n / ops
    reduce = (M * n * 4 + n * 4 + M * 8) / 3.35e12
    noise = 71 * n / ops
    want = 2 * (norms + first + 19 * later + replay) + reduce + noise
    assert counts.zo_bound_s(t, d) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(1.3286, abs=1e-4)


def test_zo_bound_mean():
    """Cell 2's: no AirComp reduction or noise walk; 8 directions."""
    from fedbench import counts
    t = traffic("mean.forward-heavy")
    d, n, M = 494_032_768, 494_075_904, 4
    ops = 16.75e12
    want = 2 * (71 * M * 8 * d + 71 * M * n + 7 * 71 * 2 * M * n
                + 71 * 8 * M * n) / ops
    assert counts.zo_bound_s(t, d) == pytest.approx(want, rel=1e-12)


def test_lm_kernel_bound_walk_heavy():
    """Per forward 49 RMSNorms over [1024, 896] and 24 attentions over
    [16, 64] rows of 14/2 heads of 64, all bound by bytes; 42 forwards."""
    from fedbench import counts
    from fedbench.models import dense
    c, t = cfg("qwen2-0.5b"), traffic("aircomp.walk-heavy")
    norm = (2 * 1024 * 896 * 4 + 4 * 896 * 4) / 3.35e12
    attn = (4 * 16 * 64 * 64 * (2 * 14 + 2 * 2)) / 3.35e12
    assert counts.lm_kernel_bound_s(dense, c, t) == pytest.approx(
        42 * (49 * norm + 24 * attn), rel=1e-12)


def test_flops_per_round():
    from fedbench import counts
    from fedbench.models import dense
    c, t = cfg("qwen2-0.5b"), traffic("mean.forward-heavy")
    # 2 iterates x (8 + 1) forwards x 4 clients x 4 rows of 256
    assert counts.flops_per_round(dense, c, t) == \
        18 * 16 * dense.forward_flops(c, 256)
