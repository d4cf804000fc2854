"""The port's edge installer (``deploy/install_torch.sh``) and its
requirements (``requirements_torch.txt``), checked without installing:
the script parses, the runner it writes starts ``tti_torch.cli run``, it
stops before touching anything when the NVIDIA driver or the CUDA toolkit
is missing, and the requirements hold none of the JAX stack."""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "deploy" / "install_torch.sh"
BASH = shutil.which("bash")

pytestmark = pytest.mark.skipif(BASH is None, reason="no bash on this host")


def _runner(install_dir: str) -> str:
    """The runner the installer writes to ``install_dir``/run.sh: its
    heredoc, expanded by bash as the installer expands it."""
    text = SCRIPT.read_text()
    body = re.search(r'cat > "\$\{INSTALL_DIR\}/run.sh" <<RUNEOF\n(.*?)\nRUNEOF\n', text,
                     re.S).group(1)
    requirements = re.search(r'^REQUIREMENTS="([^"]+)"$', text, re.M).group(1)
    expand = (f'INSTALL_DIR="{install_dir}"\nREQUIREMENTS="{requirements}"\n'
              f'cat <<RUNEOF\n{body}\nRUNEOF\n')
    return subprocess.run([BASH, "-c", expand], capture_output=True, text=True,
                          check=True).stdout


def test_installer_parses():
    proc = subprocess.run([BASH, "-n", str(SCRIPT)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_runner_starts_the_port(tmp_path):
    runner = _runner("/opt/tti")
    assert "exec ./venv/bin/python -m tti_torch.cli run" in runner
    assert not re.search(r"\btti\.cli\b", runner)
    assert "pip install --quiet -r requirements_torch.txt" in runner
    assert "-- requirements_torch.txt" in runner and 'cd "/opt/tti"' in runner
    path = tmp_path / "run.sh"
    path.write_text(runner)
    assert subprocess.run([BASH, "-n", str(path)]).returncode == 0


def test_unit_keeps_the_service_name():
    name = re.compile(r'^SERVICE_NAME="([^"]+)"$', re.M)
    ours = name.search(SCRIPT.read_text()).group(1)
    theirs = name.search((REPO / "deploy" / "install.sh").read_text()).group(1)
    assert ours == theirs == "tti-inspection"
    assert "Restart=on-failure" in SCRIPT.read_text()


def test_stops_without_the_driver_or_nvcc(tmp_path):
    """With nothing on PATH the script names what is missing and exits 1
    before it installs or writes anything."""
    empty = tmp_path / "bin"
    empty.mkdir()
    target = tmp_path / "opt"
    proc = subprocess.run([BASH, str(SCRIPT), str(target), "nobody"], capture_output=True,
                          text=True, env={"PATH": str(empty), "CUDA_HOME": str(tmp_path / "no")},
                          timeout=60)
    assert proc.returncode == 1
    assert "missing: nvidia-smi" in proc.stderr
    if not Path("/usr/local/cuda/bin/nvcc").exists():
        assert "missing: nvcc" in proc.stderr
    assert not target.exists()


def test_requirements_name_torch_and_no_jax_stack():
    names = set()
    for line in (REPO / "requirements_torch.txt").read_text().splitlines():
        line = line.split("#")[0].strip()
        if line:
            names.add(re.match(r"[A-Za-z0-9_.\-]+", line).group(0).lower())
    assert {"torch", "numpy", "einops", "opencv-contrib-python", "pyserial",
            "mysql-connector-python", "paho-mqtt", "pytest"} <= names
    assert not names & {"jax", "jaxlib", "flax", "optax", "orbax", "orbax-checkpoint", "msgpack"}
