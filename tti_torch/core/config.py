"""Typed configuration (copy of ``tti.core.config``): a tree of frozen
dataclasses, each section with an explicit ``from_env`` constructor under
the reference's environment names, a built-in ``.env`` parser, and
validation as an explicit call. :func:`load_config` builds the tree from the
process environment merged over a ``.env`` file (the file loses).

Differences from the reference, all deliberate:
- the runtime's switches (the reference's ``TTI_REMAP``, ``TTI_WARP_*`` and
  the like), which the reference reads from the process environment where
  it builds or traces its step, are parsed here by
  :meth:`RuntimeSwitches.from_env`, from the same merged environment as
  every other setting (so ``.env`` sets them too), carried by ``AppConfig``
  and handed to ``InspectionPipeline`` as arguments (``with_subcell_from``
  reads ``TTI_READOUT_CAL`` from the process environment, as the reference
  does);
- the readout calibration offsets must be finite. The reference treats 0.0
  as "unset" and would carry a NaN offset from a sidecar into every
  measurement; here a non-finite value raises ConfigError when it is set or
  loaded.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import Any, Mapping

from tti_torch.core.errors import ConfigError


def env_bool(env: Mapping[str, str], name: str, default: bool) -> bool:
    raw = env.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def env_int(env: Mapping[str, str], name: str, default: int) -> int:
    raw = env.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def env_float(env: Mapping[str, str], name: str, default: float) -> float:
    raw = env.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def env_str(env: Mapping[str, str], name: str, default: str | None) -> str | None:
    raw = env.get(name)
    return default if raw is None else raw


def load_dotenv_file(path: str = ".env") -> dict[str, str]:
    """Minimal .env parser: KEY=VALUE lines, # comments, quotes stripped."""
    out: dict[str, str] = {}
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            out[key.strip()] = value.strip().strip("'\"")
    return out


@dataclass(frozen=True)
class CameraConfig:
    """Camera capture settings."""

    index: str | int | None = None  # None: probe with services.hardware.find_camera()
    width: int = 1280
    height: int = 960
    auto_exposure: int = 3  # V4L2: 1 manual, 3 auto
    exposure: float = 3.5

    @staticmethod
    def from_env(env: Mapping[str, str]) -> "CameraConfig":
        return CameraConfig(
            index=env_str(env, "CAMERA_INDEX", None),
            width=env_int(env, "CALIB_W", 1280),
            height=env_int(env, "CALIB_H", 960),
            auto_exposure=env_int(env, "CAMERA_AUTO_EXPOSURE", 3),
            exposure=env_float(env, "CAMERA_EXPOSURE", 3.5),
        )


@dataclass(frozen=True)
class BoardConfig:
    """ChArUco board for extrinsic calibration."""

    dict_name: str = "DICT_4X4_50"
    squares_x: int = 5
    squares_y: int = 6
    square_length_m: float = 0.010
    marker_length_m: float = 0.008
    min_corners: int = 6
    capture_delay_s: float = 5.0
    invert_gray: bool = True  # detection runs on inverted grayscale


@dataclass(frozen=True)
class ModelConfig:
    """Detector/segmenter settings."""

    weights: str = "single_needle_model.ckpt"
    variant: str = "n"  # yolov8 scale: n / s / m
    num_classes: int = 2
    stitch_class_id: int = 0
    fabric_class_id: int = 1
    conf_thresh: float = 0.20
    iou_thresh: float = 0.25
    max_detections: int = 200
    nms_pre_topk: int = 256  # candidates entering the KxK NMS IoU matrix
    image_size: int = 960
    letterbox: str = "rect"  # 'rect' (Ultralytics auto minimal-rect) | 'square'
    dtype: str = "bfloat16"  # compute dtype; parameters are loaded in f32
    mask_stride: int = 4  # proto grid = input / mask_stride (4 or 2)
    proto_head: str = "deconv"  # mask_stride=2 second stage: deconv | subpixel

    def __post_init__(self) -> None:
        if self.mask_stride not in (2, 4):
            raise ValueError(f"mask_stride must be 2 or 4, got {self.mask_stride}")
        if self.proto_head not in ("deconv", "subpixel"):
            raise ValueError(
                f"proto_head must be 'deconv' or 'subpixel', got {self.proto_head!r}")
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype must be 'bfloat16' or 'float32', got {self.dtype!r}")

    @staticmethod
    def from_env(env: Mapping[str, str]) -> "ModelConfig":
        return ModelConfig(
            weights=env_str(env, "TTI_WEIGHTS", "single_needle_model.ckpt") or "",
            variant=env_str(env, "TTI_MODEL_VARIANT", "n") or "n",
            conf_thresh=env_float(env, "CONF_THRESH", 0.20),
            iou_thresh=env_float(env, "IOU_THRESH", 0.25),
            max_detections=env_int(env, "MAX_DETECTIONS", 200),
            image_size=env_int(env, "TTI_IMAGE_SIZE", 960),
            letterbox=env_str(env, "TTI_LETTERBOX", "rect") or "rect",
            dtype=env_str(env, "TTI_DTYPE", "bfloat16") or "bfloat16",
            mask_stride=env_int(env, "TTI_MASK_STRIDE", 4),
            proto_head=env_str(env, "TTI_PROTO_HEAD", "deconv") or "deconv",
        )


@dataclass(frozen=True)
class RoiConfig:
    """Pixel ROI gating: detections with bbox centers outside are dropped."""

    enabled: bool = True
    x_min: int = 10
    x_max: int = 1270
    y_min: int = 300
    y_max: int = 760

    @staticmethod
    def from_env(env: Mapping[str, str], width: int = 1280, height: int = 960) -> "RoiConfig":
        return RoiConfig(
            enabled=env_bool(env, "ROI_ENABLED", True),
            x_min=env_int(env, "ROI_X_MIN", 10),
            x_max=env_int(env, "ROI_X_MAX", width - 10),
            y_min=env_int(env, "ROI_Y_MIN", 300),
            y_max=env_int(env, "ROI_Y_MAX", height - 200),
        )

    def validate(self, width: int, height: int) -> None:
        if not self.enabled:
            return
        if not (0 <= self.x_min < self.x_max <= width):
            raise ConfigError(f"Invalid ROI X bounds: {self.x_min}..{self.x_max} for width {width}")
        if not (0 <= self.y_min < self.y_max <= height):
            raise ConfigError(f"Invalid ROI Y bounds: {self.y_min}..{self.y_max} for height {height}")


def readout_cal_enabled(env: Mapping[str, str]) -> bool:
    """``TTI_READOUT_CAL``: the sidecar's readout offsets apply unless it is
    0, false, no or off (case and surrounding whitespace ignored)."""
    return env.get("TTI_READOUT_CAL", "1").strip().lower() not in ("0", "false", "no", "off")


def _finite_offset(name: str, value: Any) -> float:
    value = float(value)
    if not math.isfinite(value):
        raise ConfigError(f"{name} must be finite, got {value!r}")
    return value


@dataclass(frozen=True)
class MeasureConfig:
    """Measurement-core knobs (same fields and defaults as the reference)."""

    frame_buffer: int = 8  # temporal median window
    min_stitches: int = 3
    max_px_distance: float = 250.0  # envelope proximity gate
    envelope_neighborhood: int = 3  # +-columns around centroid
    skip_cluster: bool = False
    two_row_threshold_px: float = 30.0
    max_stitches: int = 64  # fixed-shape budget for per-stitch arrays
    max_stats_dets: int = 64  # top-score detections entering mask statistics
    undistort_iters: int = 5  # fixed-point iterations (5 == cv2 parity)
    # Sub-cell readout for soft-mask-trained nets; None = follow the sidecar.
    subcell_edge: bool | None = None
    # Envelope readout override; None = follow subcell_edge.
    subcell_envelope: bool | None = None
    # Per-checkpoint readout calibration, added to the raw mm outputs.
    cal_edge_mm: float = 0.0
    cal_width_mm: float = 0.0

    def __post_init__(self) -> None:
        _finite_offset("cal_edge_mm", self.cal_edge_mm)
        _finite_offset("cal_width_mm", self.cal_width_mm)

    @property
    def envelope_subcell(self) -> bool:
        """Effective envelope readout after auto-resolution."""
        if self.subcell_envelope is not None:
            return self.subcell_envelope
        return bool(self.subcell_edge)

    @staticmethod
    def from_env(env: Mapping[str, str]) -> "MeasureConfig":
        def tri(name: str) -> bool | None:
            raw = env.get(name)
            return None if raw is None else raw.strip().lower() in ("1", "true", "yes", "on")

        return MeasureConfig(subcell_edge=tri("TTI_SUBCELL_EDGE"),
                             subcell_envelope=tri("TTI_SUBCELL_ENVELOPE"))

    def with_subcell_from(self, ckpt_meta: Mapping[str, Any]) -> "MeasureConfig":
        """Resolve auto (None) readouts and the calibration offsets against a
        checkpoint sidecar, as the reference does: per-class keys
        (soft_stitch / soft_fabric) split the two readouts, the legacy
        ``soft_masks`` flag drives both, an explicit ``subcell_envelope`` pin
        wins, and explicit (non-zero) config wins over the sidecar. A
        non-finite sidecar offset raises ConfigError. ``TTI_READOUT_CAL``
        (process environment) set to 0, false, no or off drops both offsets,
        explicit config included."""
        sub = self.subcell_edge
        env = self.subcell_envelope
        legacy = bool(ckpt_meta.get("soft_masks", False))
        if sub is None:
            sub = bool(ckpt_meta.get("soft_stitch", legacy))
        if env is None and "subcell_envelope" in ckpt_meta:
            env = bool(ckpt_meta["subcell_envelope"])
        if env is None and ("soft_fabric" in ckpt_meta or "soft_stitch" in ckpt_meta):
            env = bool(ckpt_meta.get("soft_fabric", legacy))
        cal_e, cal_w = self.cal_edge_mm, self.cal_width_mm
        if not readout_cal_enabled(os.environ):
            cal_e = cal_w = 0.0
        else:
            if cal_e == 0.0:
                cal_e = _finite_offset("cal_edge_mm", ckpt_meta.get("cal_edge_mm", 0.0))
            if cal_w == 0.0:
                cal_w = _finite_offset("cal_width_mm", ckpt_meta.get("cal_width_mm", 0.0))
        return dataclasses.replace(self, subcell_edge=sub, subcell_envelope=env,
                                   cal_edge_mm=cal_e, cal_width_mm=cal_w)


@dataclass(frozen=True)
class ValidationConfig:
    """Measurement validity gates and offsets."""

    seam_lower_mm: float = 3.5
    seam_upper_mm: float = 8.0
    stitch_lower_mm: float = 2.8
    stitch_upper_mm: float = 4.15
    seam_length_offset_mm: float = -1.3
    stitch_width_offset_mm: float = -1.0
    valid_buffer: int = 5  # buffered-average window
    jitter_seam_mm: float = 0.1  # +-jitter on the buffered fallback
    jitter_width_mm: float = 0.08

    @staticmethod
    def from_env(env: Mapping[str, str]) -> "ValidationConfig":
        return ValidationConfig(
            seam_length_offset_mm=env_float(env, "SEAM_LENGTH_OFFSET", -1.3),
            stitch_width_offset_mm=env_float(env, "STITCH_WIDTH_OFFSET", -1.0),
        )


@dataclass(frozen=True)
class SerialConfig:
    """ESP32 stitch-counter link."""

    port: str | None = None  # None: probe with find_esp32()
    baudrate: int = 115200
    timeout_s: float = 1.0
    reconnect_interval_s: float = 5.0
    max_buffer: int = 8192  # partial-line cap

    @staticmethod
    def from_env(env: Mapping[str, str]) -> "SerialConfig":
        return SerialConfig(port=env_str(env, "SERIAL_PORT", None))


@dataclass(frozen=True)
class DatabaseConfig:
    """Measurement persistence: backend 'mysql' or 'sqlite' (same schema)."""

    backend: str = "sqlite"
    host: str | None = None
    user: str | None = None
    password: str | None = None
    database: str | None = None
    table: str | None = None
    sqlite_path: str = "tti_measurements.db"

    @staticmethod
    def from_env(env: Mapping[str, str]) -> "DatabaseConfig":
        host = env_str(env, "DB_HOST", None)
        return DatabaseConfig(
            backend=env_str(env, "TTI_DB_BACKEND", "mysql" if host else "sqlite") or "sqlite",
            host=host,
            user=env_str(env, "DB_USER", None),
            password=env_str(env, "DB_PASSWORD", None),
            database=env_str(env, "DB_DATABASE", None),
            table=env_str(env, "DB_TABLE", None),
            sqlite_path=env_str(env, "TTI_SQLITE_PATH", "tti_measurements.db")
            or "tti_measurements.db",
        )

    def validate(self) -> None:
        """The MySQL backend needs every connection field."""
        if self.backend != "mysql":
            return
        missing = [key for key in ("host", "user", "password", "database", "table")
                   if getattr(self, key) is None]
        if missing:
            raise ConfigError("Missing required environment variables: "
                              + ", ".join(f"DB_{m.upper()}" for m in missing))


@dataclass(frozen=True)
class MqttConfig:
    """Heartbeat publisher."""

    server: str | None = None
    port: int = 8883
    username: str | None = None
    password: str | None = None
    device_id: str | None = None  # defaults to the DB table name
    interval_s: float = 2.0
    tls_insecure: bool = True

    @property
    def topic(self) -> str:
        return f"machine/{self.device_id or 'unknown'}/status/heartbeat"

    @staticmethod
    def from_env(env: Mapping[str, str], device_id: str | None = None) -> "MqttConfig":
        return MqttConfig(
            server=env_str(env, "MQTT_SERVER", None),
            port=env_int(env, "MQTT_PORT", 8883),
            username=env_str(env, "MQTT_USERNAME", None),
            password=env_str(env, "MQTT_PASSWORD", None),
            device_id=device_id or env_str(env, "DB_TABLE", None),
            tls_insecure=env_bool(env, "MQTT_TLS_INSECURE", True),
        )


@dataclass(frozen=True)
class RuntimeConfig:
    """Application loop settings. ``load_config`` reads none of them from
    the environment (as in the reference): callers that want another
    cadence or directory build the section themselves."""

    inference_interval_s: float = 2.0
    save_dir: str = "saved_annotations"
    log_debug: bool = True
    show_windows: bool = False
    file_retention_hours: float = 24.0
    file_cleanup_interval_s: float = 3600.0
    intrinsics_file: str = "camera_calibration.json"
    extrinsics_file: str = "extrinsics.json"
    batch_size: int = 8  # frames per device step
    num_streams: int = 1  # camera streams
    mesh_shape: tuple[int, ...] = ()  # the reference's field; neither package reads it


# Reference switches with no counterpart in the port, and why; the CLI logs
# each one that is set.
NO_COUNTERPART = {
    "TTI_INPUT_LAYOUT": "XLA's choice of the frames' device layout; PyTorch takes the frames "
                        "as they are",
    "TTI_MASKSTATS": "the choice among the TPU's mask-statistics routes; the port always runs "
                     "kernels A and B",
    "TTI_REMAP_SWAR": "the gather always blends with the SWAR integer lerp",
    "TTI_REMAP_SKIP_PAD_ROWS": "the gather always skips the letterbox pad rows",
    "TTI_LETTERBOX_DECIMATE": "the port's resize at an exact decimation gives the decimated "
                              "pixels already",
    "TTI_LETTERBOX_ROWSLICE": "a TPU layout choice of the resize; the values are the same",
    "TTI_REMAP_U8_DECIMATE": "the gather always packs the decimated bytes at an exact "
                             "decimation; the output is bit-identical to the float resize's",
    "TTI_JAX_CACHE_DIR": "XLA's persistent compilation cache; PyTorch runs eagerly, and the "
                         "kernels' libraries are cached in build/ by source hash",
}


# Why ``TTI_APPROX_TOPK=1`` is refused (by the CLI before anything is built,
# and by ``tools/tune_device_torch.py`` in the row of its trial).
APPROX_TOPK_REFUSAL = (
    "TTI_APPROX_TOPK=1 is not ported: it is the TPU's approximate top-k (jax.lax.approx_max_k, "
    "a partial reduce at recall 0.99), which may miss candidates; the card's exact stable "
    "top-k has no approximate form here. Unset TTI_APPROX_TOPK.")


# The switches of NO_COUNTERPART that the reference's CLI reads from the
# process environment before every command (the compilation cache), logged
# by the CLI, not by the step.
PROCESS_SWITCHES = ("TTI_JAX_CACHE_DIR",)


def check_process_switches(env: Mapping[str, str]) -> tuple[str, ...]:
    """The set names of :data:`PROCESS_SWITCHES`. The reference's other
    process-level switches, the multi-host triple (``TTI_COORDINATOR``,
    ``TTI_NUM_PROCESSES``, ``TTI_PROCESS_ID``), are served:
    :func:`tti_torch.parallel.dcn.init_distributed` reads them."""
    return tuple(name for name in PROCESS_SWITCHES if name in env)


@dataclass(frozen=True)
class RuntimeSwitches:
    """The reference's runtime switches, parsed as the reference parses them
    (``tti/parallel/runtime.py``, ``tti/preprocess/remap.py``,
    ``tti/kernels/maskstats.py``); :meth:`pipeline_kwargs` gives them to
    ``InspectionPipeline``. ``approx_topk`` has no port: the CLI refuses it.
    ``no_counterpart`` lists the set names of :data:`NO_COUNTERPART`."""

    remap: str = "twopass"  # TTI_REMAP: twopass | packed
    warp_s2d: bool = True  # TTI_WARP_S2D: on unless "0"
    warp_block: int | None = None  # TTI_WARP_BLOCKED: "0" dense, else the block width
    warp_col_expand: bool = False  # TTI_WARP_COLEXPAND=1
    lazy_decode: bool = False  # TTI_LAZY_DECODE=1
    fused_head: bool = False  # TTI_FUSED_HEAD=1
    fold_bn: bool = True  # TTI_FOLDED_BN: on unless "0"
    maskstats_logits: str = "auto"  # TTI_MASKSTATS_LOGITS: f32 | bf16, else auto
    approx_topk: bool = False  # TTI_APPROX_TOPK=1
    quant: str = ""  # TTI_QUANT: "" | int8 | int8s (anything else raises in the step)
    quant_scales: str | None = None  # TTI_QUANT_SCALES: the int8s calibration file
    no_counterpart: tuple[str, ...] = ()

    @staticmethod
    def from_env(env: Mapping[str, str]) -> "RuntimeSwitches":
        blocked = env.get("TTI_WARP_BLOCKED")
        try:
            block = (int(blocked) or None) if blocked else None
        except ValueError:
            raise ConfigError(f"TTI_WARP_BLOCKED must be an integer, got {blocked!r}") from None
        logits = env.get("TTI_MASKSTATS_LOGITS")
        return RuntimeSwitches(
            remap=env.get("TTI_REMAP", "twopass"),
            warp_s2d=env.get("TTI_WARP_S2D", "1") != "0",
            warp_block=block,
            warp_col_expand=env.get("TTI_WARP_COLEXPAND") == "1",
            lazy_decode=env.get("TTI_LAZY_DECODE") == "1",
            fused_head=env.get("TTI_FUSED_HEAD") == "1",
            fold_bn=env.get("TTI_FOLDED_BN", "1") != "0",
            maskstats_logits=logits if logits in ("f32", "bf16") else "auto",
            approx_topk=env.get("TTI_APPROX_TOPK") == "1",
            quant=env.get("TTI_QUANT", ""),
            quant_scales=env.get("TTI_QUANT_SCALES") or None,
            no_counterpart=tuple(name for name in NO_COUNTERPART
                                 if name in env and name not in PROCESS_SWITCHES),
        )

    def pipeline_kwargs(self) -> dict[str, Any]:
        """The ``InspectionPipeline`` arguments these switches set."""
        return {name: getattr(self, name) for name in (
            "remap", "warp_s2d", "warp_block", "warp_col_expand", "lazy_decode", "fused_head",
            "fold_bn", "maskstats_logits", "quant", "quant_scales")}


@dataclass(frozen=True)
class AppConfig:
    """Top-level config tree."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    board: BoardConfig = field(default_factory=BoardConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    roi: RoiConfig = field(default_factory=RoiConfig)
    measure: MeasureConfig = field(default_factory=MeasureConfig)
    validation: ValidationConfig = field(default_factory=ValidationConfig)
    serial: SerialConfig = field(default_factory=SerialConfig)
    database: DatabaseConfig = field(default_factory=DatabaseConfig)
    mqtt: MqttConfig = field(default_factory=MqttConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    switches: RuntimeSwitches = field(default_factory=RuntimeSwitches)

    def validate(self) -> "AppConfig":
        self.roi.validate(self.camera.width, self.camera.height)
        self.database.validate()
        return self

    def replace(self, **sections) -> "AppConfig":
        return dataclasses.replace(self, **sections)


def load_config(dotenv_path: str | None = ".env", env: Mapping[str, str] | None = None,
                validate: bool = True) -> AppConfig:
    """AppConfig from the process environment (or ``env``) merged over a
    .env file (the file loses)."""
    merged: dict[str, str] = {}
    if dotenv_path:
        merged.update(load_dotenv_file(dotenv_path))
    merged.update(dict(os.environ if env is None else env))
    camera = CameraConfig.from_env(merged)
    cfg = AppConfig(
        camera=camera,
        model=ModelConfig.from_env(merged),
        roi=RoiConfig.from_env(merged, camera.width, camera.height),
        measure=MeasureConfig.from_env(merged),
        validation=ValidationConfig.from_env(merged),
        serial=SerialConfig.from_env(merged),
        database=DatabaseConfig.from_env(merged),
        mqtt=MqttConfig.from_env(merged, device_id=merged.get("DB_TABLE")),
        switches=RuntimeSwitches.from_env(merged),
    )
    return cfg.validate() if validate else cfg
