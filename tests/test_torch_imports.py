"""The port imports neither jax, cv2 nor the JAX package, and yaml only
inside Config.from_yaml_file — the card's machine has none of them."""
import os
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        print(len(mods))
    """)
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
