"""The application orchestrator, the reference's ``main.py`` (port of
``tti.app.orchestrator``).

Reproduces the reference's orchestration semantics (reference: main.py:56-355)
on top of the inspection step on one card:

- startup extrinsic calibration with stale-extrinsics fallback (main.py:25-53),
- component init with degrade-don't-die: DB, serial, cleaner, MQTT each
  continue as None/no-op on failure (main.py:100-155),
- daily total-distance reset + resume from the last DB record
  (main.py:104-125,168),
- measurement loop: camera read with 10-strike reconnect (main.py:189-199),
  inference every INFERENCE_INTERVAL seconds (main.py:209), measurement offsets
  (main.py:229-232), range-validity gating (main.py:251-261), buffered-average
  fallback with +-jitter (main.py:263-278), distance integration
  ``total += stitch_delta * stitch_width`` and DB insert (main.py:280-291),
  annotated JPEG per processed frame into a per-session directory
  (main.py:296-314),
- cleanup of every service on exit (main.py:334-355).

Injectable clock/sleep/rng/frame-source make the whole loop unit-testable
(tests/test_torch_orchestrator.py) — the reference needs real hardware for any
of it.

Differences from ``tti``: the temporal median's state lives on the
pipeline's device (each frame uploads its two raw readings and reads back the
two medians), and the rectified-frame overlay keys on the pipeline's ``warp``
(the reference asks for a ``remap_xy`` attribute its own step no longer has,
so it draws rectified geometry on the distorted frame).
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from collections import deque
from datetime import datetime
from typing import Callable

import numpy as np
import torch

from tti_torch.app.annotate import annotate_frame, draw_measurement_geometry, envelope_to_polyline
from tti_torch.app.results import measurement_to_dict
from tti_torch.app.sources import FrameSource, frames_iter
from tti_torch.core.config import AppConfig
from tti_torch.core.logging import StageTimer, get_logger
from tti_torch.measure.pipeline import FrameMeasurement, init_measure_state, smooth_measurement
from tti_torch.services.cleaner import FileCleanerThread
from tti_torch.services.database import DatabaseHandler
from tti_torch.services.mqtt import MqttHeartbeat
from tti_torch.services.serial_reader import SerialReader

log = get_logger("app.orchestrator")

MAX_RECONNECT_ATTEMPTS = 10  # (reference: main.py:180)


def run_startup_calibration(
    config: AppConfig, source: FrameSource, solver: str = "tti"
) -> bool:
    """Extrinsic calibration gate with stale-extrinsics fallback
    (reference: main.py:25-53). True when the loop may run: fresh
    extrinsics were written, or calibration failed and an extrinsics file
    is on disk (with a warning). Without intrinsics, only a file on disk
    lets the loop run."""
    from tti_torch.calib.charuco import create_charuco_board, run_extrinsic_calibration
    from tti_torch.calib.io import load_intrinsics

    try:
        K, dist, _, _ = load_intrinsics(config.runtime.intrinsics_file)
    except Exception as e:
        log.error("cannot load intrinsics: %s", e)
        return os.path.exists(config.runtime.extrinsics_file)

    try:
        board = create_charuco_board(config.board)
        ok = run_extrinsic_calibration(
            frames_iter(source), K, dist, config.runtime.extrinsics_file,
            board=board, solver=solver,
        )
    except Exception as e:
        log.warning("calibration error: %s", e)
        ok = False

    if ok:
        log.info("calibration complete")
        return True
    if os.path.exists(config.runtime.extrinsics_file):
        log.warning("calibration failed; using existing extrinsics file")
        return True
    log.error("calibration failed and no extrinsics on disk — cannot continue")
    return False


class Orchestrator:
    """Init + measurement loop + cleanup, one camera stream."""

    def __init__(
        self,
        config: AppConfig,
        pipeline,  # tti_torch.parallel.runtime.InspectionPipeline
        source: FrameSource,
        clock: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
        rng: random.Random | None = None,
        save_annotated: bool = True,
        show: bool = False,
    ) -> None:
        self.config = config
        self.pipeline = pipeline
        self.source = source
        self.clock = clock
        self.sleep = sleep
        self.rng = rng or random.Random()
        self.save_annotated = save_annotated
        # Live display of the annotated frame in the hot loop with 'q' to quit
        # (reference: main.py:296-329). Off by default: production runs are
        # headless under systemd.
        self.show = show
        self._window = None
        self.timer = StageTimer()

        self.db: DatabaseHandler | None = None
        self.serial: SerialReader | None = None
        self.cleaner: FileCleanerThread | None = None
        self.heartbeat: MqttHeartbeat | None = None

        self.total_distance_mm = 0.0
        self.last_stitch_count = 0
        self.frame_count = 0
        v = config.validation
        # Buffered-average fallback seeds (reference: main.py:183-184).
        self.valid_seam_buffer: deque[float] = deque([6.5] * v.valid_buffer, maxlen=v.valid_buffer)
        self.valid_width_buffer: deque[float] = deque([3.9] * v.valid_buffer, maxlen=v.valid_buffer)
        self.measure_state = init_measure_state(config.measure.frame_buffer,
                                                device=pipeline.device)

        self.session_dir: str | None = None

    # -- init / teardown (degrade, don't die: reference main.py:100-155) ------

    def init_services(self) -> None:
        cfg = self.config
        db = DatabaseHandler(cfg.database)
        if db.connect():
            self.db = db
            self._daily_reset()
            last = db.get_last_record_total_distance()
            self.total_distance_mm = float(last) if last is not None else 0.0
            log.info("starting total distance: %.2f mm", self.total_distance_mm)
        else:
            log.warning("database unavailable — continuing without persistence")

        serial = SerialReader(cfg.serial)
        if serial.start_reading():
            self.serial = serial
        else:
            log.warning("serial unavailable — continuing without stitch counter")

        self.cleaner = FileCleanerThread(
            cfg.runtime.save_dir,
            cfg.runtime.file_retention_hours,
            cfg.runtime.file_cleanup_interval_s,
        )
        self.cleaner.start()

        try:
            if cfg.mqtt.server:
                self.heartbeat = MqttHeartbeat(cfg.mqtt)
                self.heartbeat.start()
        except Exception as e:
            log.warning("mqtt heartbeat not started: %s", e)

        os.makedirs(cfg.runtime.save_dir, exist_ok=True)
        session = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        self.session_dir = os.path.join(cfg.runtime.save_dir, session)
        os.makedirs(self.session_dir, exist_ok=True)

    def _daily_reset(self) -> None:
        """Zero-insert on a new day / first run (reference: main.py:104-125)."""
        assert self.db is not None
        last_date = self.db.get_last_record_date()
        today = datetime.now().date()
        if last_date is None or last_date != today:
            self.db.insert_measurement(
                total_distance=0.0, stitch_length=0.0, seam_allowance=0.0
            )
            log.info("total distance reset to 0 (new day or first record)")

    def shutdown(self) -> None:
        if self.serial:
            self.serial.stop()
        if self.db:
            self.db.close()
        if self.cleaner:
            self.cleaner.stop()
        self.source.release()
        if self.heartbeat:
            self.heartbeat.stop()
        if self._window is not None:
            try:
                import cv2

                cv2.destroyWindow(self._window)
            except Exception:
                pass
        log.info("shutdown complete: %d frames processed", self.frame_count)

    # -- one measurement tick --------------------------------------------------

    def process_once(self, frame: np.ndarray) -> dict:
        """Run one frame through the device pipeline + the reference's fusion,
        gating, buffering and integration logic. Returns the measurement dict
        augmented with fusion state (for logging/tests)."""
        return self.finish_frame(self.dispatch_frame(frame))

    def dispatch_frame(self, frame: np.ndarray):
        """Non-blocking device dispatch of one frame. The returned handle is
        finished by :meth:`finish_frame`; in the pipelined loop the NEXT
        frame's dispatch overlaps this frame's device compute (the single-
        camera counterpart of MultiStreamRunner.step_pipelined). Pipelines
        without an async API (test fakes) degrade to a blocking dispatch."""
        async_fn = getattr(self.pipeline, "process_batch_async", None)
        with self.timer.stage("dispatch"):
            if async_fn is None:
                return (frame, self.pipeline.process_batch(frame[None]), True)
            return (frame, async_fn(frame[None]), False)

    def finish_frame(self, handle) -> dict:
        """Fetch a dispatched frame's device results and run the host-side
        fusion/gating/integration on them."""
        _, outs, on_host = handle
        if not on_host:
            with self.timer.stage("device"):
                outs = self.pipeline.outputs_to_host(outs)
        return self._fuse_outputs(outs)

    def _fuse_outputs(self, outs) -> dict:
        cfg = self.config
        overflows = outs.budget_overflows(cfg.model, cfg.measure)
        exceeded = [k for k, v in overflows.items() if bool(np.any(v))]
        if exceeded:
            log.warning(
                "static budget exceeded: %s (counts=%s) — lowest-score "
                "detections were dropped at that stage; raise the budget in "
                "config if crowded scenes are expected",
                exceeded,
                {k: int(v[0]) for k, v in (outs.telemetry or {}).items()},
            )
        meas_batch = outs.measurements
        if meas_batch is not None:
            result = measurement_to_dict(self._smooth(_index_measurement(meas_batch, 0)))
        else:
            result = {"edge_distance_mm": None, "stitch_width_mm": None,
                      "stitch_count": 0, "timestamp": datetime.now()}

        current_count = self.serial.get_stitch_count() if self.serial else self.last_stitch_count
        stitch_delta = current_count - self.last_stitch_count
        self.last_stitch_count = current_count

        seam = result["edge_distance_mm"]
        width = result["stitch_width_mm"]
        # Offsets only on present values (reference: main.py:229-232).
        if seam is not None:
            seam += cfg.validation.seam_length_offset_mm
        if width is not None:
            width += cfg.validation.stitch_width_offset_mm

        v = cfg.validation
        valid_seam = seam is not None and v.seam_lower_mm < seam < v.seam_upper_mm
        valid_width = width is not None and v.stitch_lower_mm < width < v.stitch_upper_mm
        has_valid = valid_seam and valid_width

        if has_valid:
            self.valid_seam_buffer.append(seam)
            self.valid_width_buffer.append(width)
        elif self.valid_seam_buffer and self.valid_width_buffer:
            # Buffered average + jitter (reference: main.py:270-278).
            seam = sum(self.valid_seam_buffer) / len(self.valid_seam_buffer) + self.rng.uniform(
                -v.jitter_seam_mm, v.jitter_seam_mm
            )
            width = sum(self.valid_width_buffer) / len(self.valid_width_buffer) + self.rng.uniform(
                -v.jitter_width_mm, v.jitter_width_mm
            )
            has_valid = True

        moved = 0.0
        inserted = False
        if stitch_delta > 0 and has_valid:
            moved = stitch_delta * width
            self.total_distance_mm += moved
            if self.db:
                inserted = self.db.insert_measurement(
                    total_distance=round(self.total_distance_mm, 1),
                    stitch_length=round(width, 1),
                    seam_allowance=round(seam, 1),
                )
                if not inserted:
                    log.warning("db insert failed — will retry on next valid measurement")

        result.update(
            seam_mm=seam, width_mm=width, stitch_delta=stitch_delta,
            stitch_count_hw=current_count, moved_mm=moved,
            total_mm=self.total_distance_mm, valid=has_valid, inserted=inserted,
            outputs=outs,
        )
        # Structured measurement record (replaces the reference's emoji prints,
        # main.py:238-248,305; machine-parseable with TTI_LOG_JSON=1).
        log.info(
            "measurement",
            extra={
                "tti_seam_mm": None if seam is None else round(seam, 3),
                "tti_width_mm": None if width is None else round(width, 3),
                "tti_stitch_delta": stitch_delta,
                "tti_count_hw": current_count,
                "tti_moved_mm": round(moved, 3),
                "tti_total_mm": round(self.total_distance_mm, 3),
                "tti_valid": has_valid,
                "tti_inserted": inserted,
            },
        )
        return result

    def _smooth(self, meas: FrameMeasurement) -> FrameMeasurement:
        """The temporal median of one frame's host measurement, with the
        state on the pipeline's device: the two raw readings go up in one
        copy and the two medians come back in one."""
        raw = np.asarray([meas.raw_edge_mm, meas.raw_width_mm], np.float32)
        raw_dev = torch.as_tensor(raw, device=self.measure_state.dist_buf.device)
        frame = dataclasses.replace(meas, raw_edge_mm=raw_dev[0], raw_width_mm=raw_dev[1])
        self.measure_state, smoothed = smooth_measurement(self.measure_state, frame)
        edge, width = torch.stack([smoothed.edge_distance_mm,
                                   smoothed.stitch_width_mm]).cpu().numpy()
        return dataclasses.replace(meas, edge_distance_mm=edge, stitch_width_mm=width)

    def render_annotated(self, frame: np.ndarray, result: dict) -> np.ndarray | None:
        """Annotated copy of the frame (boxes/envelope/HUD), or None if cv2 is
        unavailable."""
        try:
            import cv2
        except ImportError:
            return None
        outs = result["outputs"]
        # When the pipeline rectifies frames (it has a warp), its geometry is
        # in undistorted frame coordinates — draw on an undistorted copy so
        # overlays line up.
        if self.pipeline.warp is not None:
            calib = self.pipeline.calibration
            frame = cv2.undistort(frame, calib.K, calib.dist)
        hud = []
        if result["valid"]:
            hud.append(
                f"Count: {result['stitch_count_hw']} | Moved: {result['moved_mm']:.2f}mm | "
                f"Total: {result['total_mm']:.2f}mm | Seam: {result['seam_mm']:.2f}mm | "
                f"Width: {result['width_mm']:.2f}mm"
            )
        else:
            hud.append(f"Stitch count: {result['stitch_count_hw']} (waiting for measurements)")
        envelope_xy = None
        if outs.envelope is not None:
            envelope_xy = envelope_to_polyline(outs.envelope[0], self.pipeline.spec)
        annotated = annotate_frame(
            frame,
            outs.boxes_frame[0], outs.classes[0], outs.valid[0],
            self.config.model.stitch_class_id, self.config.model.fabric_class_id,
            envelope_frame_xy=envelope_xy,
            roi_bounds=self.pipeline.roi_bounds,
            hud_lines=hud,
        )
        if outs.stitches is not None:
            annotated = draw_measurement_geometry(annotated, outs.stitches,
                                                  None, index=0)
        return annotated

    def save_annotated_frame(self, frame: np.ndarray, result: dict,
                             annotated: np.ndarray | None = None) -> str | None:
        if not self.save_annotated or self.session_dir is None:
            return None
        annotated = annotated if annotated is not None else self.render_annotated(frame, result)
        if annotated is None:
            return None
        import cv2

        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        path = os.path.join(self.session_dir, f"frame_{self.frame_count:05d}_{ts}.jpg")
        cv2.imwrite(path, annotated)
        return path

    def _show_frame(self, annotated: np.ndarray | None) -> bool:
        """Display the annotated frame; returns False when the user quits
        ('q', reference main.py:326-329)."""
        if annotated is None:
            return True
        try:
            import cv2
        except ImportError:
            return True
        if self._window is None:
            self._window = "tti run (q to quit)"
            cv2.namedWindow(self._window, cv2.WINDOW_NORMAL)
        cv2.imshow(self._window, annotated)
        return (cv2.waitKey(1) & 0xFF) != ord("q")

    # -- the loop -----------------------------------------------------------------

    def _complete(self, handle) -> bool:
        """Finish a dispatched frame: host fusion, annotation, save/show,
        frame accounting. Returns False when the display user quit."""
        frame = handle[0]
        result = self.finish_frame(handle)
        annotated = (self.render_annotated(frame, result)
                     if (self.save_annotated or self.show) else None)
        self.save_annotated_frame(frame, result, annotated)
        self.frame_count += 1
        if self.show and not self._show_frame(annotated):
            log.info("display window closed by user ('q')")
            return False
        return True

    def run(self, max_frames: int | None = None, pipelined: bool = False) -> None:
        """The measurement loop (reference: main.py:187-329).

        pipelined=True double-buffers the single-camera path: frame N+1's
        dispatch (and the inter-tick host work) overlaps frame N's device
        compute, so results lag one tick. Irrelevant at the reference's 2 s
        cadence, but it makes `tti run` saturate the device at interval 0 the
        same way the multi-camera MultiStreamRunner does."""
        last_inference = 0.0
        reconnect_attempts = 0
        reconnect_cycles = 0
        pending = None
        dispatched = 0
        try:
            while True:
                ok, frame = self.source.read()
                if not ok:
                    reconnect_attempts += 1
                    if reconnect_attempts >= MAX_RECONNECT_ATTEMPTS:
                        # Bounded runs (tests/replay): if one reconnect didn't
                        # restore frames, the source is exhausted — stop instead
                        # of spinning forever.
                        if max_frames is not None and reconnect_cycles >= 1:
                            break
                        log.warning("camera disconnected — reconnecting")
                        self.source.reconnect()
                        reconnect_attempts = 0
                        reconnect_cycles += 1
                    self.sleep(0.1)
                    continue
                reconnect_attempts = 0
                reconnect_cycles = 0

                now = self.clock()
                if now - last_inference >= self.config.runtime.inference_interval_s:
                    if pipelined:
                        # Dispatch first: frame N-1's fetch/fusion below runs
                        # while THIS frame computes on device.
                        handle = self.dispatch_frame(frame)
                        dispatched += 1
                        if pending is not None and not self._complete(pending):
                            pending = None
                            break
                        pending = handle
                        last_inference = now
                        if max_frames is not None and dispatched >= max_frames:
                            break
                    else:
                        if not self._complete(self.dispatch_frame(frame)):
                            break
                        last_inference = now
                        if max_frames is not None and self.frame_count >= max_frames:
                            break
        except KeyboardInterrupt:
            log.info("interrupted by user")
        finally:
            if pending is not None:
                self._complete(pending)
            self.shutdown()


def _index_measurement(meas_batch: FrameMeasurement, i: int) -> FrameMeasurement:
    """Element ``i`` of a batched measurement (every field indexed)."""
    return dataclasses.replace(meas_batch, **{f.name: getattr(meas_batch, f.name)[i]
                                              for f in dataclasses.fields(meas_batch)})
