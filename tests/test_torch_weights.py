"""The port's ultralytics route (``rtvm_tpu_torch/models/yolo/weights.py`` and
``ObjectDetector``'s ``.pt`` branch) against the JAX package's
(``rtvm_tpu/models/yolo/weights.py``).

The state dicts are synthetic and laid out as ultralytics lays them out, as
tests/test_weights.py builds them: per module the interleaved conv and
BatchNorm tensors in declaration order, every leaf a distinct value. A real
ultralytics checkpoint pickles ultralytics' classes, which neither package
can unpickle without that package; the ``.pt`` files here are ``torch.save``
of nested plain ``nn.Module``s whose ``state_dict`` has ultralytics' keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rtvm_tpu.detect.detector import ObjectDetector as JaxDetector
from rtvm_tpu.models.yolo import model as JYM
from rtvm_tpu.models.yolo import postprocess as JP
from rtvm_tpu.models.yolo import weights as JW
from rtvm_tpu.models.yolo.train_synth import make_eval_set
from rtvm_tpu_torch.detect.detector import ObjectDetector
from rtvm_tpu_torch.models.yolo import model as TYM
from rtvm_tpu_torch.models.yolo import postprocess as TP
from rtvm_tpu_torch.models.yolo import weights as TW
from rtvm_tpu_torch.models.yolo.convert import flax_to_torch, state_dict_key

torch.set_num_threads(1)  # tier 1 runs several test workers at once

IMGSZ = 160
LOGIT_TOL = 1e-5  # of the largest |logit|: float32 on both sides
F32_SCORE_GAP = 1e-4  # tests/test_torch_detect.py's float32 bound


def _conv_keys(prefix):
    return [f"{prefix}.conv.weight", f"{prefix}.bn.weight", f"{prefix}.bn.bias",
            f"{prefix}.bn.running_mean", f"{prefix}.bn.running_var",
            f"{prefix}.bn.num_batches_tracked"]


def _c2f_keys(prefix, n):
    ks = _conv_keys(f"{prefix}.cv1") + _conv_keys(f"{prefix}.cv2")
    for i in range(n):
        ks += _conv_keys(f"{prefix}.m.{i}.cv1") + _conv_keys(f"{prefix}.m.{i}.cv2")
    return ks


def _v8n_keys():
    """tests/test_weights.py:_v8n_state_keys."""
    ks = _conv_keys("model.0") + _conv_keys("model.1") + _c2f_keys("model.2", 1)
    ks += _conv_keys("model.3") + _c2f_keys("model.4", 2)
    ks += _conv_keys("model.5") + _c2f_keys("model.6", 2)
    ks += _conv_keys("model.7") + _c2f_keys("model.8", 1)
    ks += _conv_keys("model.9.cv1") + _conv_keys("model.9.cv2")
    ks += _c2f_keys("model.12", 1) + _c2f_keys("model.15", 1)
    ks += _conv_keys("model.16") + _c2f_keys("model.18", 1)
    ks += _conv_keys("model.19") + _c2f_keys("model.21", 1)
    for branch in ("cv2", "cv3"):
        for s in range(3):
            ks += _conv_keys(f"model.22.{branch}.{s}.0") + _conv_keys(f"model.22.{branch}.{s}.1")
            ks += [f"model.22.{branch}.{s}.2.weight", f"model.22.{branch}.{s}.2.bias"]
    return ks + ["model.22.dfl.conv.weight"]


def _c3k2_keys(prefix, c3k):
    ks = _conv_keys(f"{prefix}.cv1") + _conv_keys(f"{prefix}.cv2")
    if c3k:
        ks += sum((_conv_keys(f"{prefix}.m.0.{c}") for c in ("cv1", "cv2", "cv3")), [])
        for j in range(2):
            ks += _conv_keys(f"{prefix}.m.0.m.{j}.cv1") + _conv_keys(f"{prefix}.m.0.m.{j}.cv2")
    else:
        ks += _conv_keys(f"{prefix}.m.0.cv1") + _conv_keys(f"{prefix}.m.0.cv2")
    return ks


def _yolo11_keys(c3k_at):
    """tests/test_weights.py:_yolo11n_state_keys for any scale of depth 0.50
    (n, s, m): one block per C3k2 and C2PSA, c3k=True at the layers c3k_at."""
    ks = _conv_keys("model.0") + _conv_keys("model.1")
    for i, conv in ((2, None), (4, 3), (6, 5), (8, 7)):
        ks += _conv_keys(f"model.{conv}") if conv else []
        ks += _c3k2_keys(f"model.{i}", str(i) in c3k_at)
    ks += _conv_keys("model.9.cv1") + _conv_keys("model.9.cv2")
    ks += _conv_keys("model.10.cv1") + _conv_keys("model.10.cv2")
    ks += sum((_conv_keys(f"model.10.m.0.attn.{a}") for a in ("qkv", "proj", "pe")), [])
    ks += _conv_keys("model.10.m.0.ffn.0") + _conv_keys("model.10.m.0.ffn.1")
    ks += _c3k2_keys("model.13", "13" in c3k_at) + _c3k2_keys("model.16", "16" in c3k_at)
    ks += _conv_keys("model.17") + _c3k2_keys("model.19", "19" in c3k_at)
    ks += _conv_keys("model.20") + _c3k2_keys("model.22", "22" in c3k_at)
    for s in range(3):
        ks += _conv_keys(f"model.23.cv2.{s}.0") + _conv_keys(f"model.23.cv2.{s}.1")
        ks += [f"model.23.cv2.{s}.2.weight", f"model.23.cv2.{s}.2.bias"]
    for s in range(3):
        for a in range(2):
            ks += _conv_keys(f"model.23.cv3.{s}.{a}.0") + _conv_keys(f"model.23.cv3.{s}.{a}.1")
        ks += [f"model.23.cv3.{s}.2.weight", f"model.23.cv3.{s}.2.bias"]
    return ks + ["model.23.dfl.conv.weight"]


NS_C3K = ("6", "8", "22")
DEEP_C3K = ("2", "4", "6", "8", "13", "16", "19", "22")
KEYS = {"yolov8n": _v8n_keys(), "yolo11n": _yolo11_keys(NS_C3K),
        "yolo11s": _yolo11_keys(NS_C3K), "yolo11m": _yolo11_keys(DEEP_C3K)}


def _extra(key):
    """The tensors with no weight of their own: BatchNorm's step count, the
    fixed DFL convolution."""
    if key.endswith("num_batches_tracked"):
        return np.zeros((), np.int64)
    return np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)


def _state_from_port(variant, values):
    """An ultralytics state dict for `variant` whose tensors are `values`
    (port state_dict keys -> arrays), placed by the JAX package's key map."""
    state = {}
    for key in KEYS[variant]:
        m = JW.ult_key_to_flax(key, variant)
        state[key] = _extra(key) if m is None else values[
            state_dict_key("/".join((m[0],) + m[1]))[0]]
    return state


def _distinct(sd, rng):
    """Every tensor of a state_dict a distinct, plausible value: BatchNorm
    statistics and affine terms near their identity, weights small."""
    out = {}
    for k, v in sd.items():
        shape = tuple(v.shape)
        if k.endswith(".var"):
            out[k] = rng.uniform(0.5, 1.5, shape)
        elif k.endswith((".scale",)):
            out[k] = rng.uniform(0.5, 1.5, shape)
        elif k.endswith((".mean", ".bias")):
            out[k] = rng.normal(0.0, 0.1, shape)
        else:
            out[k] = rng.normal(0.0, 0.5 / np.sqrt(max(1, np.prod(shape[1:]))), shape)
        out[k] = out[k].astype(np.float32)
    return out


@pytest.mark.parametrize("variant", sorted(KEYS))
def test_key_map_is_jax_s(variant):
    if variant.startswith("yolo11"):
        assert TW.c3k_layer_indices(variant) == JW.c3k_layer_indices(variant)
    for key in KEYS[variant]:
        assert TW.ult_key_to_flax(key, variant) == JW.ult_key_to_flax(key, variant), key
    with pytest.raises(KeyError):  # a yolo11 checkpoint fed to the v8 graph
        TW.ult_key_to_flax("model.10.m.0.attn.qkv.conv.weight", "yolov8n")


@pytest.mark.parametrize("variant", ["yolov8n", "yolo11n"])
def test_converted_state_dict_is_jax_s(variant):
    """Against JAX's convert_to_flax, carried to the port's layout by
    flax_to_torch, on every tensor, exactly."""
    _, variables = JYM.build_yolo(variant, num_classes=80, imgsz=64, seed=0)
    counter = [0]

    def fill(x):  # tests/test_weights.py's distinct value per leaf
        counter[0] += 1
        x = np.asarray(x)
        return np.full(x.shape, float(counter[0]), np.float32) + (
            np.arange(x.size, dtype=np.float32).reshape(x.shape) / max(x.size, 1))

    target = jax.tree_util.tree_map(fill, jax.tree_util.tree_map(np.asarray, dict(variables)))
    state = {}
    for key in KEYS[variant]:
        m = JW.ult_key_to_flax(key, variant)
        if m is None:
            state[key] = _extra(key)
            continue
        node = target[m[0]]
        for p in m[1]:
            node = node[p]
        state[key] = np.transpose(node, (3, 2, 0, 1)) if m[2] else np.asarray(node)
    want = flax_to_torch(JW.convert_to_flax(state, variables, variant=variant))
    got = TW.convert_to_state_dict(state, TYM.build_yolo(variant, 80, device="cpu"), variant)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_deep_scale_round_trips_through_its_c3k_layout():
    """yolo11m nests C3k at every C3k2 layer (n and s only at 6, 8, 22)."""
    assert TW.c3k_layer_indices("yolo11m") == frozenset(DEEP_C3K)
    assert TW.c3k_layer_indices("yolo11s") == frozenset(NS_C3K)
    model = TYM.build_yolo("yolo11m", 80, device="cpu")
    values = _distinct({k: v for k, v in model.state_dict().items()}, np.random.RandomState(3))
    got = TW.convert_to_state_dict(_state_from_port("yolo11m", values), model, "yolo11m")
    assert set(got) == set(values)
    for k, v in values.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_a_missing_or_misshapen_tensor_raises():
    model = TYM.build_yolo("yolov8n", 80, device="cpu")
    values = _distinct(model.state_dict(), np.random.RandomState(4))
    state = _state_from_port("yolov8n", values)
    TW.convert_to_state_dict(state, model, "yolov8n")  # whole: converts
    short = dict(state)
    del short["model.4.m.1.cv2.bn.running_var"]
    with pytest.raises(ValueError, match="not in the checkpoint"):
        TW.convert_to_state_dict(short, model, "yolov8n")
    bad = dict(state)
    bad["model.0.conv.weight"] = np.zeros((17, 3, 3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        TW.convert_to_state_dict(bad, model, "yolov8n")
    with pytest.raises(KeyError):
        TW.convert_to_state_dict({"model.30.conv.weight": np.zeros(1)}, model, "yolov8n")


def _ultralytics_module(state):
    """Nested plain nn.Modules whose state_dict is `state` (ultralytics'
    keys), in half precision as ultralytics saves its models."""
    root = nn.Module()
    for key, v in state.items():
        parts = key.split(".")
        node = root
        for p in parts[:-1]:
            if p not in node._modules:
                node.add_module(p, nn.Module())
            node = node._modules[p]
        t = torch.from_numpy(np.asarray(v))
        t = t.half() if t.is_floating_point() else t
        if parts[-1] in ("running_mean", "running_var", "num_batches_tracked"):
            node.register_buffer(parts[-1], t)
        else:
            node.register_parameter(parts[-1], nn.Parameter(t, requires_grad=False))
    return root


@pytest.fixture(scope="module")
def yolo11s_pt(tmp_path_factory):
    """A seeded yolo11s checkpoint in ultralytics' layout (no bundled
    yolo11s_aerial.npz, so the .pt route is taken)."""
    values = _distinct(TYM.build_yolo("yolo11s", 80, device="cpu").state_dict(),
                       np.random.RandomState(5))
    path = tmp_path_factory.mktemp("pt") / "yolo11s.pt"
    torch.save({"model": _ultralytics_module(_state_from_port("yolo11s", values))}, path)
    return str(path), values


def test_pt_loads_into_both_detectors_and_they_agree(yolo11s_pt):
    path, values = yolo11s_pt
    td = ObjectDetector("yolo11s", weights_path=path, load_world=False, device="cpu")
    assert td.weights_loaded and td.weights_source == path
    for k, v in td.model.state_dict().items():  # the values, through half precision
        np.testing.assert_array_equal(v.numpy(), values[k].astype(np.float16).astype(np.float32))
    jd = JaxDetector("yolo11s", weights_path=path, load_world=False)
    assert jd.weights_loaded and jd.weights_source == path
    imgs, _, _ = make_eval_set(n=2, size=IMGSZ, seed=4242)
    x, scale, py, px = JP.preprocess_frames(jnp.asarray(imgs), IMGSZ)
    jbox, jcls = jd.model.apply(jd.variables, x, train=False)
    (tbox, tcls), _ = td.head_logits(imgs, IMGSZ, torch.float32)
    for j, t in zip(list(jbox) + list(jcls), tbox + tcls):
        j = torch.from_numpy(np.moveaxis(np.array(j), -1, 1))
        assert float((t - j).abs().max()) <= LOGIT_TOL * float(j.abs().max())
    boxes, scores = JP.decode_predictions(jbox, jcls, jd.model.cfg.strides, jd.model.cfg.reg_max)
    dets = [JP.nms_fixed(b, s, 0.25, 0.45) for b, s in zip(boxes, scores)]
    want = TP.Detections(
        boxes=torch.from_numpy(np.stack([np.asarray(JP.unletterbox_boxes(d.boxes, scale, py, px))
                                         for d in dets])),
        scores=torch.from_numpy(np.stack([np.asarray(d.scores) for d in dets])),
        classes=torch.from_numpy(np.stack([np.asarray(d.classes) for d in dets])),
        valid=torch.from_numpy(np.stack([np.asarray(d.valid) for d in dets])))
    m = TP.match_detections(want, td._infer_fn(IMGSZ, 0.25, 0.45, torch.float32)(imgs))
    assert m["n_ref"] >= 10, m
    assert m["share"] == 1.0 and m["max_score_gap"] <= F32_SCORE_GAP, m


def test_bundled_npz_wins_over_a_pt_and_the_search_finds_a_pt(yolo11s_pt, tmp_path,
                                                                monkeypatch):
    path, _ = yolo11s_pt
    td = ObjectDetector("yolov8n", weights_path=path, load_world=False, device="cpu")
    assert td.weights_source.endswith("yolov8n_aerial.npz")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "yolo11s.pt").write_bytes(open(path, "rb").read())
    td = ObjectDetector("yolo11s", load_world=False, device="cpu")
    assert td.weights_loaded and td.weights_source == "./yolo11s.pt"
    (tmp_path / "yolo11s.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):  # the JAX class warns and keeps random weights
        ObjectDetector("yolo11s", load_world=False, device="cpu")
