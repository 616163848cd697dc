"""The port imports neither jax, cv2 nor the JAX package, and yaml only
inside Config.from_yaml_file — the card's machine has none of them. It reads
no file of the JAX package either, and its constructors default to the
card."""
import ast
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


MAPPING_MODULES = tuple("stella_vslam_tpu_torch." + m for m in (
    "mapping_module", "module.mapping_kernels", "module.local_map_cleaner",
    "module.keyframe_inserter", "match.fuse", "match.robust", "ops.triangulation",
    "ops.solve.essential", "util.map_slice", "convert"))
LOOP_MODULES = tuple("stella_vslam_tpu_torch." + m for m in (
    "global_optimization_module", "module.loop_detector", "data.bow_vocabulary",
    "data.bow_database", "ops.solve.pnp", "ops.optim.sim3", "match.projection",
    "util.drift", "util.loop_slice"))
THREADED_MODULES = tuple("stella_vslam_tpu_torch." + m for m in (
    "tracking_module", "system", "module.tracking_kernels", "camera.base", "util.perf",
    "util.streams", "util.threaded_slice", "publish.frame_publisher",
    "publish.map_publisher"))
STEREO_MODULES = tuple("stella_vslam_tpu_torch." + m for m in (
    "match.stereo", "util.stereo_rectifier", "util.stereo_slice", "util.bench",
    "feature.orb_extractor"))


def test_port_imports_without_jax_cv2_yaml():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "cv2", "yaml"):
            sys.modules[name] = None  # any import of these now raises
        import stella_vslam_tpu_torch as pkg
        mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for m in mods:
            importlib.import_module(m)
        assert "stella_vslam_tpu" not in sys.modules, "imported the JAX package"
        assert len(mods) >= 20, mods
        # the mapping and loop slices' modules are among those checked
        missing = set(MAPPING_MODULES) - set(mods)
        assert not missing, missing
        print(len(mods))
    """).replace("MAPPING_MODULES", repr(MAPPING_MODULES + LOOP_MODULES + THREADED_MODULES
                                        + STEREO_MODULES))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_config_reads_yaml_lazily(tmp_path):
    from stella_vslam_tpu_torch.config import Config

    p = tmp_path / "cfg.yaml"
    p.write_text("Camera:\n  fx: 320.0\nFeature:\n  num_levels: 4\n")
    cfg = Config.from_yaml_file(str(p))
    assert cfg.get("Feature", "num_levels") == 4
    assert Config(path=str(p)).get("Camera", "fx") == 320.0


PKG_DIR = os.path.join(REPO, "stella_vslam_tpu_torch")


def _port_modules():
    import stella_vslam_tpu_torch as pkg

    return [importlib.import_module(m.name) for m in
            pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]


def test_port_refers_to_no_path_of_the_jax_package():
    """No string in the port's code (docstrings aside) names the JAX
    package's directory, and loading the OpenCV pair table opens no file
    under it."""
    for root, _, files in os.walk(PKG_DIR):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            tree = ast.parse(open(path).read())
            docs = {id(n.body[0].value) for n in ast.walk(tree)
                    if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
                    and n.body and isinstance(n.body[0], ast.Expr)}
            for node in ast.walk(tree):
                if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                        and id(node) not in docs:
                    v = node.value.replace("stella_vslam_tpu_torch", "")
                    assert "stella_vslam_tpu" not in v, (path, node.value)
    code = textwrap.dedent("""
        import os, sys
        jax_dir = os.path.join(os.getcwd(), "stella_vslam_tpu") + os.sep
        opened = []
        def hook(event, args):
            if event == "open" and isinstance(args[0], str) \\
                    and os.path.abspath(args[0]).startswith(jax_dir):
                opened.append(args[0])
        sys.addaudithook(hook)
        from stella_vslam_tpu_torch.feature import orb_pattern
        pairs = orb_pattern.opencv_brief_pattern()
        assert pairs.shape == (256, 4), pairs.shape
        assert not opened, opened
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_opencv_pairs_copy_is_byte_identical():
    with open(os.path.join(REPO, "stella_vslam_tpu", "feature",
                           "opencv_orb_pairs.npy"), "rb") as f:
        ref = f.read()
    with open(os.path.join(PKG_DIR, "feature", "opencv_orb_pairs.npy"), "rb") as f:
        assert f.read() == ref


def test_default_vocabulary_copy_is_byte_identical():
    with open(os.path.join(REPO, "stella_vslam_tpu", "data", "vocab_default.npz"), "rb") as f:
        ref = f.read()
    with open(os.path.join(PKG_DIR, "data", "vocab_default.npz"), "rb") as f:
        assert f.read() == ref


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names neither jax nor the JAX package in an import."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    for node in ast.walk(tree):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
            [node.module or ""] if isinstance(node, ast.ImportFrom) else []
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "stella_vslam_tpu"), n


def test_public_constructors_default_to_the_card():
    """Every class of the port whose constructor takes a device defaults it
    to "cuda" (read from the signature; nothing is constructed)."""
    found = {}
    for mod in _port_modules():
        for name, cls in inspect.getmembers(mod, inspect.isclass):
            if cls.__module__ != mod.__name__ or name.startswith("_"):
                continue
            params = inspect.signature(cls.__init__).parameters
            if "device" in params:
                found[name] = params["device"].default
    expected = {"System", "TrackingModule", "TrackingKernels", "OrbExtractor",
                "DeviceLandmarkTable", "MapDatabase", "MappingModule", "MappingKernels",
                "GlobalOptimizationModule", "LoopDetector", "BowVocabulary"}
    assert expected <= set(found), sorted(found)
    assert all(v == "cuda" for v in found.values()), found


def test_system_is_threaded_by_default_as_in_jax():
    """`System(cfg)` means the same in both packages: the threaded System
    (inline_mapping defaults to False in each signature)."""
    from stella_vslam_tpu.system import System as JSystem
    from stella_vslam_tpu_torch.system import System

    ours = inspect.signature(System.__init__).parameters["inline_mapping"].default
    theirs = inspect.signature(JSystem.__init__).parameters["inline_mapping"].default
    assert ours is theirs is False
