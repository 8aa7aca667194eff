"""The inputs a run makes: the same for the same seed, other for another."""
import torch

from fb_helpers import smoke_cell

SEED = 2 ** 31 + 12345


def make(seed):
    from fedbench import inputs
    c = smoke_cell("qwen2-0.5b.aircomp.walk-heavy")
    w = inputs.Weights(c.family, c.cfg, seed, "cpu")
    tok, lab = inputs.token_pool(c.traffic, c.cfg["vocab"], seed, "cpu")
    ck, ch = inputs.key_pool(c.traffic, seed)
    idx = inputs.sample_index(w.d, seed)
    return w, tok, lab, ck, ch, idx


def test_same_seed_same_inputs():
    a, b = make(SEED), make(SEED)
    assert torch.equal(a[0].flat, b[0].flat)
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)


def test_other_seed_other_inputs():
    a, b = make(SEED), make(SEED + 1)
    assert not torch.equal(a[0].flat, b[0].flat)
    for x, y in zip(a[1:], b[1:]):
        assert not torch.equal(x, y)


def test_layout_and_draws():
    from fedbench import inputs
    w, tok, lab, ck, ch, idx = make(SEED)
    tree = dict(inputs.leaves(w.tree))
    assert torch.all(tree[("blocks", "norm1", "scale")] == 1)
    assert torch.all(tree[("blocks", "attn", "bq")] == 0)
    assert abs(float(tree[("embed", "tok")].std()) - 0.02) < 2e-3
    # labels are the tokens shifted by one, ids inside the vocabulary
    assert torch.equal(tok[..., 1:], lab[..., :-1])
    assert int(tok.min()) >= 0 and int(tok.max()) < 512
    # the clients' chains differ
    assert not torch.equal(tok[:, 0], tok[:, 1])
    assert ck.shape == (inputs.ROUNDS_POOL, 3, 2) and int(ck.max()) < 2 ** 32
    assert torch.all(idx[1:] > idx[:-1]) and int(idx[-1]) < w.d
