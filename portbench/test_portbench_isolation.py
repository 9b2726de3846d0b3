"""The isolation check: whole top-level names, and a reference that imports
nothing of the program."""

import os

from portbench import isolation


def test_top_level_names_are_compared_whole():
    assert isolation.forbidden_modules(["articulation3d_tpu_torch", "articulation3d_tpu_torch.ops",
                                        "jaxtyping", "flaxen.x", "numpy"]) == []
    assert isolation.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                                        "articulation3d_tpu.ops"]) == \
        ["articulation3d_tpu", "flax", "jax", "jaxlib"]


def test_reference_imports_nothing_of_the_program():
    assert isolation.reference_violations() == []


def test_a_reference_that_imports_the_program_is_caught(tmp_path):
    (tmp_path / "a.py").write_text("import torch\nfrom articulation3d_tpu_torch.ops import nms\n")
    (tmp_path / "b.py").write_text("import jax.numpy as jnp\n")
    (tmp_path / "c.py").write_text("from . import a\nimport articulation3d_tpu_torchx\n")
    assert isolation.reference_violations(str(tmp_path)) == [
        "a.py: articulation3d_tpu_torch.ops", "b.py: jax.numpy"]


def test_this_process_and_the_harness_hold_no_jax():
    """Importing the harness, the program and the reference loads no JAX."""
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.run, portbench.control, portbench.drivers.video_infer\n"
            "import articulation3d_tpu_torch.video.pipeline\n"
            "from portbench import isolation; print(isolation.forbidden_modules())\n"
            % isolation.os.path.dirname(os.path.dirname(isolation.__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
