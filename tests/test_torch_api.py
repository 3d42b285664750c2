"""The public surface of ``pegasus_tpu_torch`` held against ``pegasus_tpu``.

One case per public function or class *defined* in a module of the JAX
package (``jax.jit`` unwrapped), against the module of the same relative
name in the port:

* the port module defines the name;
* the reference's named parameters are a prefix of the port's, with the
  same names, kinds and defaults, in order;
* a reference ``*args`` is met by a port ``*args``, and a reference
  ``**kwargs`` by a port ``**kwargs`` or by named parameters after the
  prefix;
* the parameters that the port adds (``device``, ``generator``, ...) have
  defaults, so a call that is valid against the reference stays valid;
* a class's public methods and properties pass the same checks, inside
  the class's case.

Further cases hold each package's ``__init__`` exports (and ``__all__``),
the reference's re-exports (``# noqa: F401 (re-export)``), and that each
package of the port imports in a fresh interpreter without an import cycle
and without initialising CUDA.

``DEVIATIONS`` lists what differs on purpose, with the ROADMAP entry that
records the decision.  An entry there must *still* differ, or its case fails, so
the list cannot go stale; a name not on it must match.  Then the
binding-parity tests run the repaired calls through both packages from one
set of numpy inputs, at the tolerances stated at each test.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_api.py -q
"""

import ast
import importlib
import importlib.util
import inspect
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pegasus_tpu
from pegasus_tpu import network_gui as jng
from pegasus_tpu.ops import postprocess as jpost
from pegasus_tpu.physics import heightfield as jhf
from pegasus_tpu.physics import rigid_body as jrb
from pegasus_tpu.training.trainer import GSTrainer as JTrainer
from pegasus_tpu.training.trainer import TrainConfig as JConfig
from pegasus_tpu.training.trainer import init_from_points as j_init

from pegasus_tpu_torch import network_gui as tng
from pegasus_tpu_torch.camera import Camera
from pegasus_tpu_torch.interop import train_state_from_numpy
from pegasus_tpu_torch.ops import postprocess as tpost
from pegasus_tpu_torch.ops.rasterize_cuda import rasterize
from pegasus_tpu_torch.physics import heightfield as thf
from pegasus_tpu_torch.physics import rigid_body as trb
from pegasus_tpu_torch.testing import make_box_cloud
from pegasus_tpu_torch.training.trainer import GROUPS, GSTrainer, TrainConfig

from test_torch_physics import STATE_FIELDS, drop_case
from test_torch_training import assert_state_close, j_state_to_numpy
from test_torch_training import setup as _single_step_setup  # noqa: F401  (the shared fixture)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
REF, PORT = "pegasus_tpu", "pegasus_tpu_torch"

# {qualified name relative to the package: reason}.  A module name covers
# every case of that module.  Each reason names the ROADMAP entry that
# records the decision.
DEVIATIONS = {
    # the TPU kernels' modules and the by-decision list
    "ops.rasterize_pallas": "the Pallas forward (K1/K2); its counterpart is ops.rasterize_cuda "
                            "(csrc/composite_tiles.cu; ROADMAP queue 2)",
    "ops.pallas_vjp": "the Pallas custom VJP (K2'/K3); its counterpart is ops.composite_vjp "
                      "(csrc/composite_tiles_bwd.cu; ROADMAP queue 2)",
    # binning and rendering
    "ops.binning.bin_splats": "exact binning drops the TPU knobs: static-cap buckets, entry_cap, "
                              "pack8, lane_pad (ROADMAP queue 3, deliberate deviations)",
    "ops.binning.TileBins": "exact binning's layout: entry_splat and per-frame counts, no "
                            "overflow flag (ROADMAP queue 3, deliberate deviations)",
    "ops.rasterize_ref.RenderOutputs": "no overflow field: exact binning cannot overflow "
                                       "(ROADMAP queue 3, deliberate deviations)",
    "ops.render.FrameDataPoints": "no overflow field: exact binning cannot overflow "
                                  "(ROADMAP queue 3, deliberate deviations)",
    "ops.render.FrameEncoded": "depth_mm is int32 in [0, 65535] where the reference's "
                               "depth_mm_u16 is uint16: torch lacks uint16 arithmetic "
                               "(ROADMAP queue 3, deliberate deviations)",
    "ops.render.render_frame": "rasterize_fn=None is the forward kernel, where the reference's "
                               "default is its golden compositor (ROADMAP queue 3, deliberate "
                               "deviations)",
    # scale-out
    "parallel.mesh.shard_batch": "split_batch takes its place: one tree per lane where the "
                                 "reference returns one sharded array (ROADMAP queue 3, R2)",
    "parallel.sharded_render.rasterize_splat_sharded": "no Pallas interpret flag, and the "
                                                       "default backend is 'cuda' (ROADMAP "
                                                       "queue 3, deliberate deviations)",
    "parallel.sharded_render.rasterize_splat_sharded_batch": "no Pallas interpret flag, and the "
                                                             "default backend is 'cuda' (ROADMAP "
                                                             "queue 3, deliberate deviations)",
    # training
    "training.trainer.TrainState": "mu, nu, count in place of optax's opt_state: torch has no "
                                   "optax, the Adam state is written out (ROADMAP queue 3, "
                                   "deliberate deviations)",
    "training.trainer.GSTrainer.densify_and_prune": "a torch.Generator in place of the PRNG key "
                                                    "(ROADMAP queue 3, deliberate deviations)",
    "utils.quaternion.random_unnormalized_quat_xyzw": "(generator, shape) in place of the PRNG "
                                                      "key (ROADMAP queue 3, deliberate "
                                                      "deviations)",
    # helpers
    "utils.observability.checked": "returns the output and raises after the call, without "
                                   "errors=: torch has no checkify (ROADMAP queue 3, "
                                   "deliberate deviations)",
    "utils.observability.trace": "log_dir defaults to 'pegasus_trace' under the working "
                                 "directory, not /tmp (ROADMAP queue 3, deliberate deviations)",
    "config.GenerationConfig": "dataset_name defaults to 'pegasus_tpu_torch', so the two "
                               "packages' default runs write apart (ROADMAP queue 3, "
                               "deliberate deviations)",
}

# what the port exports in place of a deviated name
SUBSTITUTES = {"parallel.mesh.shard_batch": "split_batch"}

_VAR = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


# -- collection: the reference's surface ------------------------------------------------


def _ref_module_names():
    walk = pkgutil.walk_packages(pegasus_tpu.__path__, REF + ".")
    return sorted(m.name[len(REF) + 1:] for m in walk)


def _import(package, rel):
    return importlib.import_module(f"{package}.{rel}" if rel else package)


def _defined(module):
    """{name: object} of the public functions and classes ``module`` defines."""
    out = {}
    for name, obj in vars(module).items():
        target = inspect.unwrap(obj) if callable(obj) else obj
        if (not name.startswith("_") and (inspect.isfunction(target) or inspect.isclass(target))
                and target.__module__ == module.__name__):
            out[name] = obj
    return out


REF_MODULES = _ref_module_names()
CASES = sorted(f"{rel}.{name}" for rel in REF_MODULES for name in _defined(_import(REF, rel)))
PACKAGES = [""] + sorted(rel for rel in REF_MODULES
                         if hasattr(_import(REF, rel), "__path__"))


def _reexports():
    """[(module, name)] of the names a reference module re-exports."""
    found = []
    for rel in REF_MODULES:
        path = Path(_import(REF, rel).__file__)
        for line in path.read_text().splitlines():
            m = re.match(r"from \S+ import (.+?)\s*# noqa: F401 \(re-export\)", line)
            if m:
                found += [(rel, n.strip()) for n in m.group(1).split(",")]
    return sorted(found)


REEXPORTS = _reexports()


def _split(case):
    """'ops.binning.bin_splats' -> ('ops.binning', 'bin_splats')."""
    rel, _, name = case.rpartition(".")
    return rel, name


# -- what one case checks ------------------------------------------------------------------


def _same_default(a, b) -> bool:
    if a is b:
        return True
    try:
        return np.shape(a) == np.shape(b) and bool(np.all(np.asarray(a) == np.asarray(b)))
    except Exception:
        return False


def _signature_problems(ref, port) -> list:
    try:
        rs = inspect.signature(ref)
    except (TypeError, ValueError):
        return []  # nothing to hold (a builtin's slot)
    ps = inspect.signature(port)
    r = [p for p in rs.parameters.values() if p.kind not in _VAR]
    p = [q for q in ps.parameters.values() if q.kind not in _VAR]
    has = lambda sig, kind: any(q.kind == kind for q in sig.parameters.values())
    if [(q.name, q.kind) for q in p[: len(r)]] != [(q.name, q.kind) for q in r]:
        fmt = lambda ps_: ", ".join(f"{q.name}:{q.kind.name}" for q in ps_)
        return [f"({fmt(r)}) is not a prefix of ({fmt(p)})"]
    problems = [f"{a.name}: default {a.default!r} != {b.default!r}"
                for a, b in zip(r, p) if not _same_default(a.default, b.default)]
    if has(rs, inspect.Parameter.VAR_POSITIONAL) and not has(ps, inspect.Parameter.VAR_POSITIONAL):
        problems.append("the reference's *args is not met")
    if has(rs, inspect.Parameter.VAR_KEYWORD) and not (
            has(ps, inspect.Parameter.VAR_KEYWORD) or len(p) > len(r)):
        problems.append("the reference's **kwargs is not met")
    problems += [f"{q.name}: the port adds it without a default"
                 for q in p[len(r):] if q.default is q.empty]
    return problems


def _raw(cls, name):
    """A class attribute as written: the function under a staticmethod,
    classmethod or ``jax.jit``, or the property."""
    attr = inspect.getattr_static(cls, name)
    if isinstance(attr, (staticmethod, classmethod)):
        attr = attr.__func__
    return inspect.unwrap(attr) if callable(attr) else attr


def _public_members(cls) -> dict:
    out = {}
    for name in vars(cls):
        attr = _raw(cls, name)
        if not name.startswith("_") and (isinstance(attr, property) or inspect.isfunction(attr)):
            out[name] = attr
    return out


def _case_problems(case) -> dict:
    """{qualified name: [problem]} for one case; the name itself when the
    port module lacks it, and its methods' names for a class."""
    rel, name = _split(case)
    ref_obj = getattr(_import(REF, rel), name)
    port_module = _import(PORT, rel)
    if not hasattr(port_module, name):
        return {case: ["missing from the port"]}
    port_obj = getattr(port_module, name)
    problems = {case: _signature_problems(ref_obj, port_obj)}
    ref_cls = inspect.unwrap(ref_obj)
    if inspect.isclass(ref_cls):
        for member, ref_attr in sorted(_public_members(ref_cls).items()):
            qual = f"{case}.{member}"
            if not hasattr(port_obj, member):
                problems[qual] = ["missing from the port"]
            elif isinstance(ref_attr, property):
                is_prop = isinstance(_raw(port_obj, member), property)
                problems[qual] = [] if is_prop else ["a property in the reference"]
            else:
                problems[qual] = _signature_problems(ref_attr, _raw(port_obj, member))
    return {k: v for k, v in problems.items() if v}


def _module_deviation(rel):
    return next((m for m in DEVIATIONS if rel == m or rel.startswith(m + ".")), None)


@pytest.mark.parametrize("case", CASES)
def test_public_surface(case):
    rel, _ = _split(case)
    deviated_module = _module_deviation(rel)
    if deviated_module is not None:
        # still not ported under this name
        assert importlib.util.find_spec(f"{PORT}.{rel}") is None, (case, DEVIATIONS[deviated_module])
        return
    problems = _case_problems(case)
    for qual, found in problems.items():
        assert qual in DEVIATIONS, f"{qual}: {found}"
    stale = [k for k in DEVIATIONS if (k == case or k.startswith(case + ".")) and k not in problems]
    assert not stale, f"on DEVIATIONS but now matches the reference: {stale}"


def test_deviations_name_the_reference_and_a_reason():
    """Every entry names a module, a case or a case's member of the JAX
    package (so none is held by no case), and gives a reason with its
    ROADMAP entry."""
    for key, reason in DEVIATIONS.items():
        assert "ROADMAP queue" in reason, key
        if key in REF_MODULES:
            continue
        owner = next((c for c in CASES if key == c or key.startswith(c + ".")), None)
        assert owner is not None, key
        if key != owner:
            assert key[len(owner) + 1:] in _public_members(inspect.unwrap(
                getattr(_import(REF, _split(owner)[0]), _split(owner)[1]))), key
    assert set(SUBSTITUTES) <= set(DEVIATIONS)
    # the kernels' modules have their counterparts
    for rel in ("ops.rasterize_cuda", "ops.composite_vjp"):
        assert importlib.util.find_spec(f"{PORT}.{rel}") is not None, rel


# -- exports, re-exports, imports -----------------------------------------------------------


def _ref_exports(rel) -> list:
    """The names a reference package's ``__init__`` binds by import, or its ``__all__``."""
    module = _import(REF, rel)
    if hasattr(module, "__all__"):
        return list(module.__all__)
    tree = ast.parse(Path(module.__file__).read_text())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


def _qualified(obj):
    """The relative qualified name of a reference object: module or defining module + name."""
    if inspect.ismodule(obj):
        return obj.__name__[len(REF) + 1:]
    target = inspect.unwrap(obj)
    return f"{target.__module__[len(REF) + 1:]}.{target.__name__}"


def _port_counterpart(qual):
    if qual in REF_MODULES:
        return _import(PORT, qual)
    rel, name = _split(qual)
    return getattr(_import(PORT, rel), name)


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "root")
def test_package_exports(package):
    """The port package exports the reference package's names (minus
    ``DEVIATIONS``, with their substitutes), each the port's own object of
    the same relative name, and the same ``__all__``."""
    ref, port = _import(REF, package), _import(PORT, package)
    expected = []
    for name in _ref_exports(package):
        obj = getattr(ref, name)
        if isinstance(obj, str):  # __version__
            assert getattr(port, name) == obj, name
            expected.append(name)
            continue
        qual = _qualified(obj)
        if qual in SUBSTITUTES:
            assert not hasattr(port, name), (name, DEVIATIONS[qual])
            name, qual = SUBSTITUTES[qual], f"{_split(qual)[0]}.{SUBSTITUTES[qual]}"
        assert hasattr(port, name), f"{PORT}.{package}: {name} is not exported"
        assert getattr(port, name) is _port_counterpart(qual), name
        expected.append(name)
    if hasattr(ref, "__all__"):
        assert sorted(port.__all__) == sorted(expected)


@pytest.mark.parametrize("module,name", REEXPORTS, ids=[f"{m}.{n}" for m, n in REEXPORTS])
def test_reexports(module, name):
    ref_obj = getattr(_import(REF, module), name)
    port_obj = getattr(_import(PORT, module), name)
    assert port_obj is _port_counterpart(_qualified(ref_obj))


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "root")
def test_package_imports_alone(package):
    """A fresh interpreter imports the package first: no import cycle, no
    JAX, and CUDA is not initialised (no kernel built, no library loaded)."""
    target = f"{PORT}.{package}" if package else PORT
    code = (f"import sys, torch, {target}\n"
            "assert not torch.cuda.is_initialized()\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'pegasus_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


# -- binding parity, through both packages ---------------------------------------------------


def test_trainer_binds_the_reference_positions(_single_step_setup):
    """``GSTrainer(cfg, None, 32, 32)`` binds width and height in both, and
    one train_step of the reference-positional trainer agrees with the JAX
    one at tests/test_torch_training.py's tolerances: loss rtol 1e-4,
    parameters and Adam's first moments rtol 1e-3 / atol 2e-5, the
    densify statistic rtol 5e-2 / atol 1e-7."""
    jcams, tcams, gts, pts, colors = _single_step_setup
    jconfig = JConfig(capacity=512, densify_from_iter=10_000)
    config = TrainConfig(capacity=512, densify_from_iter=10_000)
    for trainer in (JTrainer(jconfig, None, 32, 32), GSTrainer(config, None, 32, 32, device="cpu")):
        assert (trainer.width, trainer.height, trainer.max_per_tile) == (32, 32, 1024)
    assert GSTrainer(config, None, 32, 32, device="cpu").backend == "pallas"
    jt = JTrainer(jconfig, None, 32, 32, (0.0, 0.0, 0.0), 1024, "pallas_interpret")
    tt = GSTrainer(config, None, 32, 32, (0.0, 0.0, 0.0), 1024, "pallas", device="cpu")
    s0 = jt.init_state(j_init(pts, colors, jconfig), spatial_lr_scale=0.5)
    s1, m1 = jt.train_step(s0, jcams[2], jnp.asarray(gts[2]))
    t1, m2 = tt.train_step(train_state_from_numpy(j_state_to_numpy(s0), device="cpu"), tcams[2],
                           torch.tensor(gts[2]))
    assert np.isclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    want = j_state_to_numpy(s1)
    assert_state_close(t1, want, rtol=1e-3, atol=2e-5)
    for g in GROUPS:
        np.testing.assert_allclose(t1.mu[g].numpy(), want["mu"][g], rtol=1e-3, atol=2e-5, err_msg=g)
    np.testing.assert_allclose(t1.xyz_grad_accum.numpy(), want["xyz_grad_accum"], rtol=5e-2, atol=1e-7)


def test_trainer_backend_and_render_fn():
    """"auto" and "pallas" train uncapped, "tiled" at ``max_per_tile``
    (tests/test_torch_tiled.py holds its step against the reference's);
    "pallas_interpret" raises; a given ``render_fn`` is kept as given."""
    config = TrainConfig(capacity=64)
    for backend, want in (("auto", "pallas"), ("pallas", "pallas"), ("tiled", "tiled")):
        trainer = GSTrainer(config, backend=backend, max_per_tile=64, device="cpu")
        assert (trainer.backend, trainer.max_per_tile) == (want, 64)
    with pytest.raises(ValueError, match="'auto', 'pallas' or 'tiled'"):
        GSTrainer(config, backend="pallas_interpret", device="cpu")
    render_fn = lambda *a, **k: None  # noqa: E731
    assert GSTrainer(config, render_fn=render_fn, device="cpu").render_fn is render_fn


def test_simulate_takes_the_reference_positions():
    """dt, gravity, iters and heightfield given positionally, at values
    other than the defaults, over a bumpy heightfield: the port's roll-out
    against the reference's, atol 1e-5 + rtol 1e-4."""
    (jp, tp), (js, ts) = drop_case()
    rng = np.random.default_rng(9)
    grid = (0.02 * rng.random((17, 17))).astype(np.float32)
    x0, y0, inv = np.float32(-0.6), np.float32(-0.6), np.float32(16 / 1.2)
    j_field = jhf.Heightfield(jnp.asarray(grid), jnp.float32(x0), jnp.float32(y0),
                              jnp.float32(inv), jnp.float32(inv))
    t_field = thf.Heightfield(torch.tensor(grid), *(torch.tensor(v) for v in (x0, y0, inv, inv)))
    args = (40, np.float32(1.5e-3), (0.0, 0.5, -40.0), 6)
    j_traj, j_final = jrb.simulate(jp, js, *args, j_field)
    t_traj, t_final = trb.simulate(tp, ts, *args, t_field, device="cpu")
    assert t_traj.pos.shape == (40, 4, 3)
    for f in STATE_FIELDS:
        np.testing.assert_allclose(getattr(t_traj, f).numpy(), np.asarray(getattr(j_traj, f)),
                                   atol=1e-5, rtol=1e-4, err_msg=f)
        np.testing.assert_allclose(getattr(t_final, f).numpy(), np.asarray(getattr(j_final, f)),
                                   atol=1e-5, rtol=1e-4, err_msg=f)
    # the keyword form binds the same
    kw_traj, _ = trb.simulate(tp, ts, n_steps=40, dt=args[1], gravity=args[2], iters=6,
                              heightfield=t_field, device="cpu")
    assert all(torch.equal(getattr(kw_traj, f), getattr(t_traj, f)) for f in STATE_FIELDS)


def test_ssao_takes_the_reference_key():
    """ssao(depth, normals, radius_px, n_samples, strength, key=None) in
    both packages, positionally: agree to 1e-6 absolute."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:40, 0:48].astype(np.float32)
    depth = (1.0 + 0.2 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
             + 0.05 * rng.random((40, 48))).astype(np.float32)
    depth[10:20, 12:30] -= 0.3  # a box in front
    got = tpost.ssao(torch.from_numpy(depth), None, 6, 12, 1.5, None).numpy()
    want = np.asarray(jpost.ssao(jnp.asarray(depth), None, 6, 12, 1.5, None))
    assert got.min() < 0.999  # something is occluded
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tpost.ssao(torch.from_numpy(depth), key=None).numpy(),
                                  tpost.ssao(torch.from_numpy(depth)).numpy())


def _wire_message(znear, zfar):
    rng = np.random.default_rng(12)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    W2C = np.eye(4, dtype=np.float32)
    W2C[:3, :3] = q * np.sign(np.linalg.det(q))
    W2C[:3, 3] = rng.normal(size=3)
    view = W2C.T.copy()
    view[:, 1:3] *= -1
    return {"resolution_x": 40, "resolution_y": 30, "train": False, "fov_x": 0.9, "fov_y": 0.7,
            "z_near": znear, "z_far": zfar, "shs_python": False, "rot_scale_python": False,
            "keep_alive": True, "scaling_modifier": 1.0,
            "view_matrix": [float(v) for v in view.flatten()],
            "view_projection_matrix": [float(v) for v in np.eye(4).flatten()]}


def test_wire_camera_carries_the_clip_planes():
    """A wire-viewer message with z_near / z_far gives a Camera with those
    fields in both packages (the rest to 1e-6); one without them gives the
    defaults; ``request_message`` sends the camera's own."""
    message = _wire_message(0.25, 42.0)
    jcam = jng.camera_from_message(message)
    tcam = tng.camera_from_message(message, device="cpu")
    assert (tcam.znear, tcam.zfar) == (jcam.znear, jcam.zfar) == (0.25, 42.0)
    np.testing.assert_allclose(tcam.R_w2c.numpy(), np.asarray(jcam.R_w2c), atol=1e-6)
    np.testing.assert_allclose(tcam.t_w2c.numpy(), np.asarray(jcam.t_w2c), atol=1e-6)
    assert (tcam.width, tcam.height) == (jcam.width, jcam.height) == (40, 30)
    bare = {k: v for k, v in message.items() if k not in ("z_near", "z_far")}
    jbare, tbare = jng.camera_from_message(bare), tng.camera_from_message(bare, device="cpu")
    assert (tbare.znear, tbare.zfar) == (jbare.znear, jbare.zfar) == (0.01, 100.0)
    import json

    sent = json.loads(tng.request_message(tcam)[4:])
    assert (sent["z_near"], sent["z_far"]) == (0.25, 42.0)


def test_clip_planes_leave_the_render_unchanged():
    """Projection reads neither clip plane (its near cull is at 0.2), so a
    render at other planes is bitwise the default one."""
    cloud = make_box_cloud(np.random.default_rng(13), n=300, half_extents=(0.1, 0.1, 0.1),
                           rgb=(0.5, 0.6, 0.2), object_id=1, device="cpu")
    cam = Camera.look_at((0.5, 0.3, 0.4), (0, 0, 0), (0, 0, 1), 0.9, 0.8, 48, 40, device="cpu")
    base = rasterize(cloud, cam, max_objects=2)
    clipped = rasterize(cloud, cam.replace(znear=0.6, zfar=0.7), max_objects=2)
    assert (base.alpha > 0).any()
    for field in base._fields:
        assert torch.equal(getattr(base, field), getattr(clipped, field)), field


def test_camera_replace_and_fields():
    """``Camera(..., znear, zfar)`` positionally as in the reference, and
    ``replace`` makes a new camera that shares the extrinsics."""
    R, t = torch.eye(3), torch.zeros(3)
    cam = Camera(R, t, 0.9, 0.8, 64, 48, 0.5, 20.0)
    assert (cam.znear, cam.zfar) == (0.5, 20.0)
    wide = cam.replace(width=96)
    assert (wide.width, wide.height, wide.znear, wide.zfar) == (96, 48, 0.5, 20.0)
    assert cam.width == 64 and wide.R_w2c is cam.R_w2c
    assert Camera(R, t, 0.9, 0.8).znear == 0.01 and Camera(R, t, 0.9, 0.8).zfar == 100.0


def test_camera_reexports_focal_helpers():
    from pegasus_tpu.camera import focal2fov as j_f2f, fov2focal as j_fov2f
    from pegasus_tpu_torch.camera import focal2fov, fov2focal

    for focal, pixels in ((500.0, 640), (320.5, 480)):
        assert np.isclose(focal2fov(focal, pixels), j_f2f(focal, pixels), rtol=1e-7)
        assert np.isclose(fov2focal(focal2fov(focal, pixels), pixels), j_fov2f(j_f2f(focal, pixels), pixels),
                          rtol=1e-7)
