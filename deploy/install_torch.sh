#!/usr/bin/env bash
# tti edge installer for the PyTorch/CUDA port (tti_torch): the steps of
# deploy/install.sh (groups, venv, .env template, runner with fast-forward
# self-update and daily logs, acpid power button, systemd unit with
# Restart=on-failure), idempotent and without prompts. It differs in four
# places: the runner starts `python -m tti_torch.cli run`; the venv installs
# requirements_torch.txt (and reinstalls when it changes); it stops when the
# NVIDIA driver (nvidia-smi) or the CUDA toolkit (nvcc) is missing, since
# the port's kernels build from source at first use; and it installs the same
# unit, tti-inspection, so on a line that ran the JAX service it takes its
# place.
#
# Usage: sudo bash deploy/install_torch.sh [install_dir] [service_user]
set -euo pipefail

INSTALL_DIR="${1:-/opt/tti}"
SERVICE_USER="${2:-${SUDO_USER:-$(whoami)}}"
REPO_URL="${TTI_REPO_URL:-}"
SERVICE_NAME="tti-inspection"
REQUIREMENTS="requirements_torch.txt"

echo "== tti_torch installer: dir=${INSTALL_DIR} user=${SERVICE_USER} =="

# --- the card and the CUDA toolkit (tti_torch/kernels/build.py finds nvcc
# under CUDA_HOME, /usr/local/cuda or on PATH) --------------------------------
missing=()
command -v nvidia-smi >/dev/null 2>&1 || missing+=("nvidia-smi (the NVIDIA driver)")
if ! command -v nvcc >/dev/null 2>&1 \
        && [ ! -x "${CUDA_HOME:-/usr/local/cuda}/bin/nvcc" ] \
        && [ ! -x /usr/local/cuda/bin/nvcc ]; then
    missing+=("nvcc (the CUDA toolkit: the port's kernels build from source at first use)")
fi
if [ "${#missing[@]}" -gt 0 ]; then
    for m in "${missing[@]}"; do
        echo "missing: ${m}" >&2
    done
    echo "install them, then run this script again" >&2
    exit 1
fi

# --- system dependencies (camera + serial access) ---------------------------
if command -v apt-get >/dev/null 2>&1; then
    apt-get update -qq || true
    apt-get install -y -qq python3-venv python3-dev git v4l-utils || true
fi
# Serial port access for the stitch counter (reference: dialout group).
usermod -aG dialout "${SERVICE_USER}" 2>/dev/null || true
usermod -aG video "${SERVICE_USER}" 2>/dev/null || true

# --- code --------------------------------------------------------------------
mkdir -p "${INSTALL_DIR}"
if [ -n "${REPO_URL}" ]; then
    if [ -d "${INSTALL_DIR}/.git" ]; then
        git -C "${INSTALL_DIR}" fetch --quiet || true
    else
        git clone --quiet "${REPO_URL}" "${INSTALL_DIR}"
    fi
else
    # Local install: copy the repo this script lives in.
    SRC_DIR="$(cd "$(dirname "$0")/.." && pwd)"
    if [ "${SRC_DIR}" != "${INSTALL_DIR}" ]; then
        rsync -a --exclude .git --exclude saved_annotations "${SRC_DIR}/" "${INSTALL_DIR}/"
    fi
fi

# --- python environment --------------------------------------------------------
if [ ! -d "${INSTALL_DIR}/venv" ]; then
    python3 -m venv "${INSTALL_DIR}/venv"
fi
"${INSTALL_DIR}/venv/bin/pip" install --quiet --upgrade pip
if [ -f "${INSTALL_DIR}/${REQUIREMENTS}" ]; then
    "${INSTALL_DIR}/venv/bin/pip" install --quiet -r "${INSTALL_DIR}/${REQUIREMENTS}"
fi

# --- .env ---------------------------------------------------------------------
if [ ! -f "${INSTALL_DIR}/.env" ]; then
    cat > "${INSTALL_DIR}/.env" <<'ENVEOF'
# tti_torch configuration — see tti_torch/core/config.py for every key.
# DB_HOST=
# DB_USER=
# DB_PASSWORD=
# DB_DATABASE=
# DB_TABLE=
# MQTT_SERVER=
# SEAM_LENGTH_OFFSET=-1.3
# STITCH_WIDTH_OFFSET=-1.0
ENVEOF
    echo "wrote template ${INSTALL_DIR}/.env — fill in DB/MQTT credentials"
fi

# --- runner (self-update + daily logs; reference auto_runner.sh semantics) ----
cat > "${INSTALL_DIR}/run.sh" <<RUNEOF
#!/usr/bin/env bash
set -uo pipefail
cd "${INSTALL_DIR}"
LOG_DIR="${INSTALL_DIR}/logs"
mkdir -p "\${LOG_DIR}"
LOG_FILE="\${LOG_DIR}/tti_\$(date +%F).log"

# Self-update: fast-forward only; reinstall deps when requirements changed.
if [ -d .git ]; then
    BEFORE=\$(git rev-parse HEAD 2>/dev/null || echo none)
    git fetch --quiet 2>>"\${LOG_FILE}" || true
    git merge --ff-only @{u} --quiet 2>>"\${LOG_FILE}" || true
    AFTER=\$(git rev-parse HEAD 2>/dev/null || echo none)
    if [ "\${BEFORE}" != "\${AFTER}" ] && ! git diff --quiet "\${BEFORE}" "\${AFTER}" -- ${REQUIREMENTS}; then
        ./venv/bin/pip install --quiet -r ${REQUIREMENTS} 2>>"\${LOG_FILE}" || true
    fi
fi

exec ./venv/bin/python -m tti_torch.cli run 2>&1 | tee -a "\${LOG_FILE}"
RUNEOF
chmod +x "${INSTALL_DIR}/run.sh"
chown -R "${SERVICE_USER}" "${INSTALL_DIR}"

# --- kiosk-host niceties (reference auto_run.sh §8 + §12) ---------------------
# Power button -> clean poweroff (operators have no keyboard on the line).
if command -v systemctl >/dev/null 2>&1; then
    apt-get install -y -qq acpid 2>/dev/null || true
    mkdir -p /etc/acpi/events
    cat > /etc/acpi/events/powerbtn <<'ACPIEOF'
event=button/power
action=/usr/sbin/poweroff
ACPIEOF
    systemctl restart acpid 2>/dev/null || true
    systemctl enable acpid >/dev/null 2>&1 || true
fi
# Remote-desktop support tools need Xorg; disable Wayland when GDM is present.
if [ -f /etc/gdm3/custom.conf ]; then
    sed -i 's/^#WaylandEnable=false/WaylandEnable=false/' /etc/gdm3/custom.conf
    sed -i 's/^WaylandEnable=true/WaylandEnable=false/' /etc/gdm3/custom.conf
    echo "Wayland disabled in /etc/gdm3/custom.conf (reboot required)"
fi

# --- systemd unit (Restart=on-failure, RestartSec=5 like the reference) -------
cat > "/etc/systemd/system/${SERVICE_NAME}.service" <<UNITEOF
[Unit]
Description=tti stitch measurement system (tti_torch, CUDA)
After=network-online.target
Wants=network-online.target

[Service]
Type=simple
User=${SERVICE_USER}
WorkingDirectory=${INSTALL_DIR}
ExecStart=${INSTALL_DIR}/run.sh
Restart=on-failure
RestartSec=5
Environment=PYTHONUNBUFFERED=1

[Install]
WantedBy=multi-user.target
UNITEOF

systemctl daemon-reload
systemctl enable "${SERVICE_NAME}" >/dev/null 2>&1 || true
echo "== installed. start with: systemctl start ${SERVICE_NAME} =="
