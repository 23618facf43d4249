"""No process of the benchmark may hold JAX or the JAX package: the check
compares whole top-level module names, and the benchmark, its reference
and the port's modules it drives import neither."""

from __future__ import annotations

import subprocess
import sys

from conftest import ROOT

from portbench.common import forbidden_modules


def test_whole_top_level_names_are_compared():
    assert forbidden_modules(["wsinsight_tpu_torch", "wsinsight_tpu_torch.engine.runner",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["wsinsight_tpu.engine", "jax", "jax.numpy", "jaxlib",
                              "flax.linen", "wsinsight_tpu"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib", "wsinsight_tpu", "wsinsight_tpu.engine"]


def test_the_benchmark_and_the_port_it_drives_load_no_jax():
    code = (
        "import sys\n"
        "import portbench.run, portbench.control, portbench.slides\n"
        "import portbench.drivers.cell_stream, portbench.drivers.classifier_resident\n"
        "import portbench.reference.cellvit, portbench.reference.classifier\n"
        "import portbench.reference.instances, portbench.reference.tiff\n"
        "import wsinsight_tpu_torch.engine.runner, wsinsight_tpu_torch.engine.cells\n"
        "import wsinsight_tpu_torch.engine.stream_cells, wsinsight_tpu_torch.patchlib\n"
        "import wsinsight_tpu_torch.zoo, wsinsight_tpu_torch.models\n"
        "from portbench.common import forbidden_modules\n"
        "print(forbidden_modules(list(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                                           "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "wsinsight_tpu" not in text and "import jax" not in text, path
