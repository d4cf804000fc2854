"""Serial stitch-counter reader, a host daemon thread (copy of
``tti.services.serial_reader``).

Same public contract as the reference's SerialReader
(reference: serial_reader.py:10-151): ``start_reading() / get_stitch_count() /
stop()``, newline-delimited integer protocol at 115200 baud, bounded
partial-line buffer, lock-guarded latest value, timed auto-reconnect with ESP32
re-detection, context-manager support.

Differences:
- the transport is injectable (any object with ``read_available() -> bytes``,
  ``is_open``, ``close()``), so tests script a fake counter stream without a tty
  (SURVEY.md §4: "fake serial (scripted count stream)");
- pyserial is an optional import resolved at connect time.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Protocol

from tti_torch.core.config import SerialConfig
from tti_torch.core.logging import get_logger
from tti_torch.services.hardware import find_esp32

log = get_logger("services.serial")


class Transport(Protocol):
    @property
    def is_open(self) -> bool: ...

    def read_available(self) -> bytes: ...

    def close(self) -> None: ...


class PySerialTransport:
    """Default transport over pyserial."""

    def __init__(self, port: str, baudrate: int, timeout: float) -> None:
        import serial  # optional dependency

        self._conn = serial.Serial(port=port, baudrate=baudrate, timeout=timeout)
        time.sleep(2)  # settle, as the reference does (serial_reader.py:35)

    @property
    def is_open(self) -> bool:
        return bool(self._conn and self._conn.is_open)

    def read_available(self) -> bytes:
        if self._conn.in_waiting:
            return self._conn.read(self._conn.in_waiting)
        return b""

    def close(self) -> None:
        self._conn.close()


class SerialReader:
    """Background thread publishing the latest hardware stitch count."""

    def __init__(
        self,
        config: SerialConfig | None = None,
        transport_factory: Callable[[str], Transport] | None = None,
        port_detector: Callable[[], str | None] = find_esp32,
    ) -> None:
        self.config = config or SerialConfig()
        self.port = self.config.port
        self._transport_factory = transport_factory
        self._port_detector = port_detector
        self._transport: Transport | None = None
        self._running = False
        self._thread: threading.Thread | None = None
        self._latest = 0
        self._lock = threading.Lock()
        self._last_reconnect = 0.0
        self._buffer = ""

    # -- connection ---------------------------------------------------------

    def _make_transport(self, port: str) -> Transport:
        if self._transport_factory is not None:
            return self._transport_factory(port)
        return PySerialTransport(port, self.config.baudrate, self.config.timeout_s)

    def connect(self) -> bool:
        port = self.port or self._port_detector()
        if port is None:
            log.warning("no serial port configured or detected")
            return False
        try:
            self._transport = self._make_transport(port)
            self.port = port
            log.info("serial connected to %s at %d baud", port, self.config.baudrate)
            return True
        except Exception as e:  # pyserial raises SerialException subclasses of Exception
            log.warning("failed to connect to serial port %s: %s", port, e)
            return False

    def _try_reconnect(self) -> None:
        now = time.monotonic()
        if now - self._last_reconnect < self.config.reconnect_interval_s:
            return
        self._last_reconnect = now
        if self._transport is not None:
            try:
                self._transport.close()
            except Exception:
                pass
            self._transport = None
        # Re-detect the port every attempt (reference: serial_reader.py:56-75).
        detected = self._port_detector()
        if detected:
            self.port = detected
        self.connect()

    # -- protocol -----------------------------------------------------------

    def _parse_available(self) -> int | None:
        """Drain available bytes, keep partial lines, return one parsed count
        (reference: serial_reader.py:77-111)."""
        if self._transport is None or not self._transport.is_open:
            self._try_reconnect()
            return None
        try:
            data = self._transport.read_available().decode("utf-8", errors="ignore")
        except Exception as e:
            log.warning("serial read error: %s", e)
            try:
                self._transport.close()
            except Exception:
                pass
            self._transport = None
            self._buffer = ""
            self._try_reconnect()
            return None
        if not data:
            return None
        self._buffer += data
        if len(self._buffer) > self.config.max_buffer:
            self._buffer = self._buffer[-self.config.max_buffer :]
        result = None
        while "\n" in self._buffer:
            line, self._buffer = self._buffer.split("\n", 1)
            line = line.strip()
            if not line:
                continue
            try:
                result = int(line)
            except ValueError:
                log.warning("non-integer serial line ignored: %r", line)
        return result

    def _read_loop(self) -> None:
        while self._running:
            try:
                count = self._parse_available()
                if count is not None:
                    with self._lock:
                        self._latest = count
                else:
                    time.sleep(0.01)
            except Exception as e:
                log.error("serial loop error: %s", e)
                self._try_reconnect()
                time.sleep(0.1)

    # -- public API (reference contract) -------------------------------------

    def start_reading(self) -> bool:
        if self._transport is None or not self._transport.is_open:
            if not self.connect():
                return False
        self._running = True
        self._thread = threading.Thread(target=self._read_loop, daemon=True, name="tti-serial")
        self._thread.start()
        return True

    def get_stitch_count(self) -> int:
        with self._lock:
            return self._latest

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=2.0)
        if self._transport is not None and self._transport.is_open:
            self._transport.close()
        log.info("serial reader stopped")

    def __enter__(self) -> "SerialReader":
        self.start_reading()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
