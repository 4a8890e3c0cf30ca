"""The port's trainer (videoquery_torch.train), its checkpoints and the core
helpers around it (core.transfer, core.profiling) against the JAX package.

- One and two TSNTrainer steps at dropout 0 against the JAX ``train_step``
  on the same numpy batch and weights: loss rtol 1e-5, every weight rtol
  2e-4 / atol 2e-6 (tests/test_distributed.py:87-116's tolerances).
- Dropout 0.5: the port's loss against the JAX network fed the port's
  mask (global_pool by JAX ``embed``, the head in numpy).
- make_optimizer against optax's add_decayed_weights + sgd(momentum) over
  two steps; memorising one batch lowers the loss.
- A bf16 forward after a step uses the new weights (the module's weight
  caches are dropped when a parameter changes).
- Checkpoints: a bitwise round trip, and resume == continuing, bit for bit.
- put_tree, local_rows, device_trace (with the spans it writes).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videoquery.nn import bn_inception as jax_bn
from videoquery.train import trainer as jax_trainer
from videoquery_torch.core.profiling import device_trace, span
from videoquery_torch.core.transfer import local_rows, put_tree
from videoquery_torch.nn.bn_inception import BNInception, dropout_keep, init_params
from videoquery_torch.train.checkpoint import load_train_state, save_train_state
from videoquery_torch.train.trainer import TrainConfig, TSNTrainer, make_optimizer

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

CFG = TrainConfig(num_segments=2, num_classes=5, dropout_rate=0.0, learning_rate=0.01)


def batch(seed, b=4, s=2, hw=64, classes=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, hw, hw, 3)).astype(np.float32),
            rng.integers(0, classes, size=(b,)))


@pytest.fixture(scope="module")
def jax_two_steps():
    """The JAX train_step twice on one batch (compiled once): the losses and
    the weights after each step."""
    params = init_params(1, num_classes=5)
    frames, labels = batch(7)
    p = jax.tree.map(jnp.asarray, params)
    opt = jax_trainer.make_optimizer(CFG).init(p)
    out = []
    for i in range(2):
        p, opt, m = jax_trainer.train_step(p, opt, jnp.asarray(frames), jnp.asarray(labels),
                                           jax.random.PRNGKey(i), CFG)
        out.append((float(m["loss"]), jax.tree.map(np.asarray, p)))
    return params, frames, labels, out


def test_train_config_defaults_match_jax():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(jax_trainer.TrainConfig())


@pytest.mark.parametrize("steps", [1, 2])
def test_train_steps_match_jax(jax_two_steps, steps):
    params, frames, labels, want = jax_two_steps
    trainer = TSNTrainer(params, CFG, device="cpu")
    for i in range(steps):
        m = trainer.step(frames, labels, seed=i)
        np.testing.assert_allclose(m["loss"], want[i][0], rtol=1e-5)
    assert trainer.steps == steps
    got, ref = trainer.params(), want[steps - 1][1]
    assert got.keys() == ref.keys()
    moved = 0
    for name in ref:
        for leaf in ("w", "b"):
            assert got[name][leaf].shape == ref[name][leaf].shape
            np.testing.assert_allclose(got[name][leaf], ref[name][leaf],
                                       rtol=2e-4, atol=2e-6, err_msg=f"{name}/{leaf}")
            moved += not np.array_equal(got[name][leaf], params[name][leaf])
    assert moved == 2 * len(ref)   # every weight and bias took the update


def test_dropout_loss_matches_jax_network_fed_the_same_mask():
    cfg = dataclasses.replace(CFG, dropout_rate=0.5)
    params = init_params(2, num_classes=5)
    frames, labels = batch(8)
    got = TSNTrainer(params, cfg, device="cpu").step(frames, labels, seed=11)["loss"]

    b, s = frames.shape[:2]
    gp = np.asarray(jax_bn.embed_jit(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(frames.reshape((b * s,) + frames.shape[2:]))),
                    np.float64)
    keep = dropout_keep(11, (b * s, 1024), 0.5).numpy()
    assert 0.4 < keep.mean() < 0.6
    h = np.where(keep, gp / 0.5, 0.0)
    logits = (h @ params["fc-action"]["w"] + params["fc-action"]["b"]).reshape(b, s, -1).mean(1)
    z = logits - logits.max(-1, keepdims=True)
    want = np.mean(np.log(np.exp(z).sum(-1)) - z[np.arange(b), labels])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_make_optimizer_equals_optax_over_two_steps():
    rng = np.random.default_rng(3)
    p0, g1, g2 = (rng.normal(size=(6, 5)).astype(np.float32) for _ in range(3))
    cfg = TrainConfig(learning_rate=0.05)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([p], cfg)
    tx = jax_trainer.make_optimizer(cfg)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for g in (g1, g2):
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    # the momentum carried into the second step (0.9 * g1' + g2')
    np.testing.assert_allclose(opt.state[p]["momentum_buffer"].numpy(),
                               np.asarray(state[1][0].trace), rtol=1e-6, atol=1e-7)


def test_memorising_one_batch_lowers_the_loss():
    trainer = TSNTrainer(init_params(0, num_classes=5), CFG, device="cpu")
    frames, labels = batch(9)
    first = trainer.step(frames, labels, seed=0)["loss"]
    for i in range(4):
        last = trainer.step(frames, labels, seed=i + 1)["loss"]
    assert np.isfinite(first) and last < first


def test_bf16_forward_after_a_step_uses_the_new_weights():
    trainer = TSNTrainer(init_params(4, num_classes=5), CFG, device="cpu")
    x = torch.from_numpy(batch(10, b=2, s=1)[0][:, 0]).to(torch.bfloat16)
    frames, labels = batch(11)
    with torch.no_grad():
        before = trainer.module.embed(x)            # fills the bf16 caches
    trainer.step(frames, labels, seed=0)
    with torch.no_grad():
        after = trainer.module.embed(x)
        fresh = BNInception(trainer.params()).embed(x)
    assert not torch.equal(after, before)
    assert torch.equal(after, fresh)


def test_checkpoint_round_trip_and_resume_equal_continuing(tmp_path):
    cfg = dataclasses.replace(CFG, dropout_rate=0.5)
    frames, labels = batch(12)
    a = TSNTrainer(init_params(5, num_classes=5), cfg, device="cpu")
    a.step(frames, labels, seed=0)
    path = save_train_state(str(tmp_path / "ckpt"), a.params(), a.opt_state(), a.steps)
    assert path.endswith(".npz") and os.path.isfile(path)
    state = load_train_state(str(tmp_path / "ckpt"))
    assert state["step"] == 1
    with np.load(path) as f:
        assert "params/conv1/7x7_s2/w" in f.files and "opt_state/fc-action/b" in f.files
    for group, tree in (("params", a.params()), ("opt_state", a.opt_state())):
        assert state[group].keys() == tree.keys()
        for name in tree:
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(state[group][name][leaf], tree[name][leaf])
    assert np.abs(state["opt_state"]["conv1/7x7_s2"]["w"]).max() > 0

    b = TSNTrainer(state["params"], cfg, device="cpu", opt_state=state["opt_state"],
                   step=state["step"])
    ma, mb = a.step(frames, labels, seed=1), b.step(frames, labels, seed=1)
    assert ma == mb and b.steps == a.steps == 2
    pa, pb = a.params(), b.params()
    for name in pa:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(pb[name][leaf], pa[name][leaf])


def test_put_tree_one_buffer_per_dtype(rng):
    tree = {
        "a": {"w": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)},
        "c": [np.arange(6, dtype=np.int32).reshape(2, 3),
              rng.normal(size=(4,)).astype(np.float64)],
        "d": np.asarray(True),
    }
    out = put_tree(tree, "cpu")
    assert out.keys() == tree.keys() and isinstance(out["c"], list)
    for got, want in ((out["a"]["w"], tree["a"]["w"]), (out["a"]["b"], tree["a"]["b"]),
                      (out["c"][0], tree["c"][0]), (out["c"][1], tree["c"][1]),
                      (out["d"], tree["d"])):
        assert got.numpy().dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    # the float32 leaves are views into one buffer
    assert (out["a"]["w"].untyped_storage().data_ptr()
            == out["a"]["b"].untyped_storage().data_ptr())
    assert put_tree({}, "cpu") == {}


def test_local_rows():
    x = np.arange(24).reshape(6, 4)
    np.testing.assert_array_equal(local_rows(x, 1, 3), x[2:4])
    np.testing.assert_array_equal(local_rows(x, 1, 2, dim=1), x[:, 2:])
    t = torch.from_numpy(x)
    assert torch.equal(local_rows(t, 2, 3), t[4:])
    with pytest.raises(ValueError, match="not divisible"):
        local_rows(x, 0, 4)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        for _ in range(2):
            with span("step"):
                torch.ones(64).cumsum(0)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    with open(tmp_path / "trace" / "spans.json") as f:
        spans = json.load(f)
    assert [s["name"] for s in spans["spans"]] == ["step", "step"]
    assert spans["totals"]["step"]["calls"] == 2 and spans["counters"] == {}
