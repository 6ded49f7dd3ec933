"""The port's YOLO model (rtvm_tpu_torch.models.yolo) against the JAX
package's, float32 on the CPU: the checkpoint reader, every module of
modules.py with Flax-initialised parameters carried by the converter, the
layout of all ten variants, and both bundled checkpoints end to end.

Tolerances: modules max |d| <= 1e-5 on outputs of order 1 (float32, summation
order only); the whole model's logits max |d| <= 1e-3 (measured below 1e-4
on logits up to ~70 in magnitude)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtvm_tpu.models.yolo import model as JM
from rtvm_tpu.models.yolo import modules as JS
from rtvm_tpu.utils.checkpoint import load_pytree_npz as jax_load_pytree_npz
from rtvm_tpu_torch.models.yolo import model as TM
from rtvm_tpu_torch.models.yolo import modules as TS
from rtvm_tpu_torch.models.yolo.convert import flax_to_state_dict, flax_to_torch, state_dict_key
from rtvm_tpu_torch.utils.checkpoint import load_pytree_npz

torch.set_num_threads(1)  # tier 1 runs several test workers at once

MODULE_TOL = 1e-5
MODEL_TOL = 1e-3
CHECKPOINTS = {"yolov8n": "weights/yolov8n_aerial.npz", "yolo11n": "weights/yolo11n_aerial.npz",
               "yolov8l": "weights/yolov8l_aerial.npz"}  # YOLOv8l: BASELINE config 5
NUM_CLASSES = 8  # the bundled checkpoints' aerial classes


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _path_str(key_path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in key_path)


def _jax_tree(variant: str, path: str):
    """The checkpoint as the JAX detector restores it (structure from an
    abstract init, so nothing is compiled)."""
    m = JM.YOLOv8(JM.YoloConfig(variant=variant, num_classes=NUM_CLASSES))
    like = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                         train=False))
    return m, jax_load_pytree_npz(path, dict(like))


@pytest.mark.parametrize("variant", sorted(CHECKPOINTS))
def test_npz_reader_matches_the_jax_loader(variant):
    ours = load_pytree_npz(CHECKPOINTS[variant])
    _, tree = _jax_tree(variant, CHECKPOINTS[variant])
    theirs = {_path_str(p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert list(ours) == list(theirs)  # same paths in the same (flatten) order
    for p in theirs:
        assert ours[p].dtype == theirs[p].dtype and np.array_equal(ours[p], theirs[p]), p
    assert len(ours) == {"yolov8n": 297, "yolo11n": 417, "yolov8l": 497}[variant]
    assert sum(v.size for v in ours.values()) == {"yolov8n": 3022792, "yolo11n": 2606760,
                                                  "yolov8l": 43682456}[variant]


def _randomise(tree, rng):
    """Flax init leaves BatchNorm at scale 1, bias 0, mean 0, var 1; give
    every BatchNorm leaf other values so that its arithmetic is tested."""
    def leaf(path, v):
        name = _path_str(path).split("/")[-1]
        v = np.asarray(v)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.randn(*v.shape)).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(tree))


# name: (Flax module, port module, input shapes NHWC)
MODULES = {
    "ConvBnSiLU_groups4": (lambda: JS.ConvBnSiLU(16, 3, 1, groups=4),
                           lambda: TS.ConvBnSiLU(8, 16, 3, 1, groups=4), [(2, 9, 11, 8)]),
    "ConvBnSiLU_stride2_noact": (lambda: JS.ConvBnSiLU(16, 3, 2, act=False),
                                 lambda: TS.ConvBnSiLU(8, 16, 3, 2, act=False), [(2, 9, 11, 8)]),
    "Bottleneck": (lambda: JS.Bottleneck(16), lambda: TS.Bottleneck(16, 16), [(2, 8, 8, 16)]),
    "C2f": (lambda: JS.C2f(16, 2, shortcut=True), lambda: TS.C2f(8, 16, 2, shortcut=True),
            [(2, 8, 10, 8)]),
    "SPPF": (lambda: JS.SPPF(16), lambda: TS.SPPF(16, 16), [(2, 7, 9, 16)]),
    "C3k2_c3k": (lambda: JS.C3k2(32, 1, c3k=True), lambda: TS.C3k2(16, 32, 1, c3k=True),
                 [(2, 8, 8, 16)]),
    "C3k2_bottleneck": (lambda: JS.C3k2(32, 2, c3k=False, expansion=0.25),
                        lambda: TS.C3k2(16, 32, 2, c3k=False, expansion=0.25), [(2, 8, 8, 16)]),
    "SpatialAttention": (lambda: JS.SpatialAttention(128, 2),
                         lambda: TS.SpatialAttention(128, 2), [(2, 4, 5, 128)]),
    "C2PSA": (lambda: JS.C2PSA(256, 1), lambda: TS.C2PSA(256, 256, 1), [(1, 3, 4, 256)]),
    "DetectHead_v8": (lambda: JS.DetectHead(8), lambda: TS.DetectHead([32, 64, 128], 8),
                      [(2, 8, 8, 32), (2, 4, 4, 64), (2, 2, 2, 128)]),
    "DetectHead_dw_cls": (lambda: JS.DetectHead(8, dw_cls=True),
                          lambda: TS.DetectHead([32, 64, 128], 8, dw_cls=True),
                          [(2, 8, 8, 32), (2, 4, 4, 64), (2, 2, 2, 128)]),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_flax(name):
    make_jax, make_torch, shapes = MODULES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    xs = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    jm = make_jax()
    arg = [jnp.asarray(x) for x in xs] if name.startswith("DetectHead") else jnp.asarray(xs[0])
    variables = _randomise(jm.init(jax.random.PRNGKey(0), arg), rng)
    want = jm.apply(variables, arg)

    tm = make_torch().eval()
    tm.load_state_dict(flax_to_torch(variables), strict=True)
    targ = [_nchw(x) for x in xs] if name.startswith("DetectHead") else _nchw(xs[0])
    with torch.no_grad():
        got = tm(targ)
    want_l = [np.asarray(a) for a in jax.tree_util.tree_leaves(want)]
    got_l = [_nhwc(t) for t in (got[0] + got[1] if isinstance(got, tuple) else [got])]
    assert [a.shape for a in got_l] == [a.shape for a in want_l]
    scale = max(float(np.abs(a).max()) for a in want_l)
    assert 0.1 < scale < 20, f"outputs of order 1 expected, max |out| {scale}"
    err = max(float(np.abs(g - w).max()) for g, w in zip(got_l, want_l))
    assert err <= MODULE_TOL, f"{name}: max |d| {err}"


def test_dfl_expectation_matches_flax():
    rng = np.random.RandomState(3)
    x = (3 * rng.randn(2, 5, 7, 64)).astype(np.float32)
    want = np.asarray(JS.dfl_expectation(jnp.asarray(x)))
    got = _nhwc(TS.dfl_expectation(_nchw(x)))
    assert got.shape == want.shape == (2, 5, 7, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=MODULE_TOL)


@pytest.mark.parametrize("variant", sorted(JM.VARIANTS) + sorted(JM.VARIANTS11))
def test_every_variant_has_the_flax_layout(variant):
    """Every Flax leaf of the variant lands on a state_dict entry of the same
    name with the converted shape, and nothing is left over."""
    jm = JM.YOLOv8(JM.YoloConfig(variant=variant, num_classes=80))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                            train=False))
    want = {}
    for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key, is_kernel = state_dict_key(_path_str(p))
        want[key] = tuple(np.empty(v.shape, np.uint8).transpose(3, 2, 0, 1).shape
                          if is_kernel else v.shape)
    with torch.device("meta"):
        sd = TM.YOLOv8(TM.YoloConfig(variant=variant, num_classes=80)).state_dict()
    assert {k: tuple(t.shape) for k, t in sd.items()} == want


def test_converter_refuses_a_checkpoint_of_another_variant():
    tree = load_pytree_npz(CHECKPOINTS["yolov8n"])
    with pytest.raises(ValueError, match="names differ"):
        flax_to_state_dict(tree, "yolo11n")
    with pytest.raises(ValueError, match="shapes differ"):
        flax_to_state_dict(tree, "yolov8s")


@pytest.mark.parametrize("variant,imgsz", [(v, s) for v in ("yolov8n", "yolo11n") for s in (64, 128)]
                         + [("yolov8l", (160, 256))])
def test_whole_model_with_the_bundled_checkpoint(variant, imgsz):
    jm, tree = _jax_tree(variant, CHECKPOINTS[variant])
    h, w = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz  # YOLOv8l: a non-square letterbox
    x = np.random.RandomState(h).rand(2, h, w, 3).astype(np.float32)
    jb, jc = jm.apply(tree, jnp.asarray(x), train=False)  # un-jitted: no compile

    tm = TM.build_yolo(variant, NUM_CLASSES, device="cpu")
    tm.load_state_dict(flax_to_state_dict(load_pytree_npz(CHECKPOINTS[variant]), variant))
    with torch.no_grad():
        tb, tc = tm(_nchw(x))
    for j, t in zip(list(jb) + list(jc), tb + tc):
        assert t.shape == _nchw(np.asarray(j)).shape
        err = float(np.abs(_nhwc(t) - np.asarray(j)).max())
        assert err <= MODEL_TOL, f"{variant} at {imgsz}: logits max |d| {err}"
