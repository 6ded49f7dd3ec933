"""The port's DepthNet trainer (rtvm_tpu_torch.models.train_depth) against
the JAX package's, float32 on the CPU, from ``weights/depthnet.npz`` at
48x64.

JAX's ``loss_fn`` and ``evaluate`` are closures inside its ``main``; the
loss is taken from the jitted ``step`` that ``main`` builds (its closure),
while ``main`` itself runs. Both ``main``s run with the recycling spawn pool
replaced by a synchronous one (``multiprocessing.get_context`` patched):
the real pool hands out whatever batch is ready first, the fake one fixes
the order.

Tolerances: the loss relative 1e-5 (measured 9.1e-7), its gradients
relative L2 1e-3 per leaf (measured 5.3e-6); after ``main --size 48 64
--batch 2 --steps 2 --init weights/depthnet.npz`` the checkpoint's
structure byte-equal and its parameters within 1e-5 on at least 0.999 of
the values (measured 0.99997), the report's abs_rel and pearson within
1e-4 (measured 3.0e-7 and 7.5e-7) and its steps and size equal.
"""

import json
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _close_share, _nchw, _np_tree, _t

from rtvm_tpu.models import train_depth as JD
from rtvm_tpu.models.depth_synth import make_depth_batch
from rtvm_tpu_torch.models import train_depth as TD
from rtvm_tpu_torch.models.depthnet import build_depthnet, state_dict_to_flax
from rtvm_tpu_torch.models.yolo.convert import flatten_tree
from rtvm_tpu_torch.utils import checkpoint as TC

torch.set_num_threads(1)  # tier 1 runs several test workers at once

INIT = "weights/depthnet.npz"
ARGS = ["--size", "48", "64", "--batch", "2", "--steps", "2", "--init", INIT]
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-3
PARAM_ATOL, PARAM_SHARE = 1e-5, 0.999
REPORT_TOL = 1e-4


class _Done:
    def __init__(self, value):
        self.value = value

    def ready(self):
        return True

    def get(self):
        return self.value


class _SyncPool:
    """A Pool that runs each job when it is submitted, in this process."""

    def __init__(self, workers, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def apply_async(self, fn, args=()):
        return _Done(fn(*args))

    def terminate(self):
        pass

    def join(self):
        pass


class _SyncContext:
    def Pool(self, *args, **kwargs):
        return _SyncPool(*args, **kwargs)


@pytest.fixture(scope="module")
def depth_runs(tmp_path_factory, request):
    """Both mains with the synchronous pool; JAX's step function captured
    from its jax.jit call (its closure holds loss_fn)."""
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    mp.setattr(multiprocessing, "get_context", lambda method=None: _SyncContext())
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    steps = []
    real_jit = jax.jit

    def recording_jit(fn, *a, **k):
        if getattr(fn, "__name__", "") == "step":
            steps.append(fn)
        return real_jit(fn, *a, **k)

    mp.setattr(jax, "jit", recording_jit)
    JD.main(ARGS + ["--out-dir", str(jdir)])
    mp.setattr(jax, "jit", real_jit)
    TD.main(ARGS + ["--out-dir", str(tdir)], device="cpu")
    closure = dict(zip(steps[0].__code__.co_freevars, (c.cell_contents for c in steps[0].__closure__)))
    return dict(jdir=jdir, tdir=tdir, loss_fn=closure["loss_fn"])


def test_depth_loss_and_gradients_match_jax(depth_runs):
    rng = np.random.RandomState(21)
    imgs, near = make_depth_batch(rng, 2, 48, 64)
    params = TC.flat_to_nested(TC.load_pytree_npz(INIT))["params"]
    jl, jg = jax.jit(jax.value_and_grad(depth_runs["loss_fn"]))(params, jnp.asarray(imgs),
                                                                 jnp.asarray(near))
    model = build_depthnet(INIT, device="cpu").train()
    tl = TD.loss_fn(model, _t(imgs), _t(near))
    tl.backward()
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    want = flatten_tree({"params": _np_tree(jg)})
    got = state_dict_to_flax({k: p.grad for k, p in model.named_parameters()})
    assert sorted(got) == sorted(want)
    for k, g in want.items():
        assert np.linalg.norm(got[k] - g) <= GRAD_RTOL * np.linalg.norm(g), k


def test_main_writes_what_jax_main_writes(depth_runs):
    jdir, tdir = depth_runs["jdir"], depth_runs["tdir"]
    with np.load(jdir / "depthnet.npz") as a, np.load(tdir / "depthnet.npz") as b:
        assert bytes(b["__treedef__"]) == bytes(a["__treedef__"])
        assert sorted(a.files) == sorted(b.files)
    want, got = (TC.load_pytree_npz(str(d / "depthnet.npz")) for d in (jdir, tdir))
    g = np.concatenate([got[k].ravel() for k in sorted(want)])
    w = np.concatenate([want[k].ravel() for k in sorted(want)])
    share, worst = _close_share(g, w, PARAM_ATOL)
    assert share >= PARAM_SHARE and worst <= 2 * 1e-3 * 2, (share, worst)
    ja, ta = (json.load(open(d / "depthnet.json")) for d in (jdir, tdir))
    assert ta["steps"] == ja["steps"] == 2 and ta["size"] == ja["size"] == [48, 64]
    for k in ("abs_rel", "pearson"):
        assert abs(ta[k] - ja[k]) <= REPORT_TOL, (k, ta[k], ja[k])


def test_main_moves_no_parameter_at_lr_0(tmp_path, monkeypatch):
    """--lr 0 leaves the checkpoint as it was (the chip phase's check of
    weights/depthnet.json relies on it)."""
    monkeypatch.setattr(multiprocessing, "get_context", lambda method=None: _SyncContext())
    TD.main(ARGS[:5] + ["--steps", "1", "--lr", "0", "--init", INIT, "--out-dir", str(tmp_path)],
            device="cpu")
    before, after = TC.load_pytree_npz(INIT), TC.load_pytree_npz(str(tmp_path / "depthnet.npz"))
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
    x = make_depth_batch(np.random.RandomState(0), 1, 48, 64)[0]
    assert build_depthnet(str(tmp_path / "depthnet.npz"), device="cpu")(_nchw(x)).shape == (1, 1, 48, 64)
