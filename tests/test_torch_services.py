"""The port's services against tti's, driven by the same fakes: a scripted
serial transport, sqlite databases, a recording MQTT client and the
retention cleaner with an injected clock. Each case runs both packages and
compares what they return, store, publish and remove."""

import dataclasses
import os
import sqlite3
import sys
import time
from datetime import datetime

import pytest

import tti.core.config as jcfg
import tti.services.cleaner as jcl
import tti.services.database as jdb
import tti.services.hardware as jhw
import tti.services.mqtt as jmq
import tti.services.serial_reader as jsr
import tti_torch.core.config as tcfg
import tti_torch.services.cleaner as tcl
import tti_torch.services.database as tdb
import tti_torch.services.hardware as thw
import tti_torch.services.mqtt as tmq
import tti_torch.services.serial_reader as tsr

PACKAGES = {"port": (tcfg, tsr, tdb, tmq, tcl, thw), "tti": (jcfg, jsr, jdb, jmq, jcl, jhw)}


class ScriptedTransport:
    """Feeds pre-scripted byte chunks, then nothing."""

    def __init__(self, chunks):
        self.chunks = list(chunks)
        self._open = True

    @property
    def is_open(self):
        return self._open

    def read_available(self):
        return self.chunks.pop(0) if self.chunks else b""

    def close(self):
        self._open = False


def both(fn):
    """fn(package modules) for the port and for tti."""
    return fn(*PACKAGES["port"]), fn(*PACKAGES["tti"])


# -- serial ---------------------------------------------------------------------

SERIAL_SCRIPTS = {
    "counts and partial lines": [b"12\n", b"4", b"5\n78", b"\n", b"", b"9\n10\n"],
    "garbage lines": [b"abc\n17\n", b"\n\n", b"x1\n", b"-3\n"],
    "buffer cap": [b"x" * 10000, b"\n5\n"],
    "utf-8 noise": [b"\xff\xfe7\n", b"8\r\n"],
}


@pytest.mark.parametrize("name", sorted(SERIAL_SCRIPTS))
def test_serial_parse_equal(name):
    def parse(cfg, sr, *_):
        reader = sr.SerialReader(cfg.SerialConfig(port="/dev/fake"),
                                 transport_factory=lambda port: ScriptedTransport(
                                     SERIAL_SCRIPTS[name]),
                                 port_detector=lambda: "/dev/fake")
        assert reader.connect()
        return [(reader._parse_available(), len(reader._buffer))
                for _ in SERIAL_SCRIPTS[name]]

    got, want = both(parse)
    assert got == want


def test_serial_thread_and_degrade_equal():
    def run(cfg, sr, *_):
        reader = sr.SerialReader(cfg.SerialConfig(port="/dev/fake"),
                                 transport_factory=lambda port: ScriptedTransport(
                                     [b"5\n", b"9\n"] + [b""] * 50),
                                 port_detector=lambda: "/dev/fake")
        assert reader.start_reading()
        deadline = time.time() + 2.0
        while reader.get_stitch_count() != 9 and time.time() < deadline:
            time.sleep(0.01)
        reader.stop()
        lost = sr.SerialReader(cfg.SerialConfig(port=None), port_detector=lambda: None)
        return reader.get_stitch_count(), lost.start_reading(), lost.get_stitch_count()

    got, want = both(run)
    assert got == want == (9, False, 0)


# -- database -------------------------------------------------------------------


def _rows(path, table):
    with sqlite3.connect(path) as con:
        return con.execute(f'SELECT stitch_length, seam_allowance, total_distance FROM "{table}" '
                           "ORDER BY id").fetchall()


def test_sqlite_round_trip_equal(tmp_path):
    def run(cfg, sr, db_mod, *_):
        tag = db_mod.__name__.split(".")[0]
        path = str(tmp_path / f"{tag}.db")
        db = db_mod.DatabaseHandler(cfg.DatabaseConfig(backend="sqlite", table="m1",
                                                       sqlite_path=path))
        seen = [db.connect(), db.get_last_record_date(), db.get_last_record_total_distance(),
                db.get_latest_measurement()]
        # The orchestrator's daily reset, then three measurements.
        seen.append(db.insert_measurement(total_distance=0.0, stitch_length=0.0,
                                          seam_allowance=0.0))
        for total, length, seam in ((39.0, 3.9, 6.5), (250.5, 5.0, 15.0), (300.1, 4.1, 6.2)):
            seen.append(db.insert_measurement(total_distance=total, stitch_length=length,
                                              seam_allowance=seam))
            time.sleep(0.002)  # distinct millisecond timestamps
        seen += [db.get_last_record_date() == datetime.now().date(),
                 db.get_last_record_total_distance()]
        latest = db.get_latest_measurement()
        seen.append({k: v for k, v in latest.items() if k != "timestamp"})
        seen.append(db.delete_measurements(latest["timestamp"]))
        seen.append(db.get_last_record_total_distance())
        db.close()
        with db_mod.DatabaseHandler(cfg.DatabaseConfig(table="m1", sqlite_path=path)) as again:
            seen.append(again.get_last_record_total_distance())
        return seen, _rows(path, "m1")

    got, want = both(run)
    assert got == want
    assert got[1] == [(0.0, 0.0, 0.0), (3.9, 6.5, 39.0), (5.0, 15.0, 250.5)]


def test_database_degrades_equal(tmp_path, monkeypatch):
    """No MySQL driver and an unopenable sqlite path: connect and every
    query fail softly, the same way in both."""
    monkeypatch.setitem(sys.modules, "mysql", None)
    monkeypatch.setitem(sys.modules, "mysql.connector", None)

    def run(cfg, sr, db_mod, *_):
        out = []
        for conf in (cfg.DatabaseConfig(backend="mysql", host="h", user="u", password="p",
                                        database="d", table="t"),
                     cfg.DatabaseConfig(sqlite_path=str(tmp_path / "missing" / "x.db"))):
            db = db_mod.DatabaseHandler(conf)
            out += [db.connect(), db.insert_measurement(1.0, 2.0, 3.0),
                    db.get_latest_measurement(), db.delete_measurements("t")]
        return out

    got, want = both(run)
    assert got == want == [False, False, None, False] * 2


# -- MQTT ---------------------------------------------------------------------------


class RecordingClient:
    def __init__(self, config):
        self.calls = [("init", config.topic)]

    def connect(self, host, port, keepalive):
        self.calls.append(("connect", host, port, keepalive))

    def loop_start(self):
        self.calls.append(("loop_start",))

    def loop_stop(self):
        self.calls.append(("loop_stop",))

    def disconnect(self):
        self.calls.append(("disconnect",))

    def publish(self, topic, payload, qos=0, retain=False):
        self.calls.append(("publish", topic, payload, qos, retain))


def test_mqtt_heartbeat_payloads_equal(monkeypatch):
    monkeypatch.setitem(sys.modules, "paho", None)
    monkeypatch.setitem(sys.modules, "paho.mqtt", None)
    monkeypatch.setitem(sys.modules, "paho.mqtt.client", None)

    def run(cfg, sr, db, mq, *_):
        conf = dataclasses.replace(cfg.MqttConfig(server="broker", port=1883, device_id="line7"),
                                   interval_s=0.01)
        hb = mq.MqttHeartbeat(conf, client_factory=RecordingClient)
        hb.start()
        deadline = time.time() + 2.0
        while sum(c[0] == "publish" for c in hb.client.calls) < 3 and time.time() < deadline:
            time.sleep(0.005)
        hb.stop()
        hb.join(timeout=2.0)
        assert not hb.is_alive()
        calls = hb.client.calls
        publishes = [c for c in calls if c[0] == "publish"]
        null = mq.MqttHeartbeat(cfg.MqttConfig(device_id="x"))  # paho absent: the null client
        null.client.publish("t", "on")
        return (calls[:3], publishes[0], len(publishes) >= 3, calls[-2:],
                type(null.client).__name__, null.client.published)

    got, want = both(run)
    assert got == want
    assert got[1] == ("publish", "machine/line7/status/heartbeat", "on", 0, False)


# -- cleaner ---------------------------------------------------------------------------


def test_cleaner_with_injected_clock_equal(tmp_path):
    def tree(root):
        now = 1_000_000.0
        for rel, age_h in (("a/old.jpg", 30), ("a/new.jpg", 1), ("b/old1.jpg", 25),
                           ("b/c/old2.jpg", 48), ("top_old.jpg", 100), ("top_new.jpg", 0)):
            path = root / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(b"x" * 100)
            os.utime(path, (now - age_h * 3600, now - age_h * 3600))
        return now

    def run(cfg, sr, db, mq, cl, *_):
        root = tmp_path / cl.__name__.split(".")[0]
        now = tree(root)
        cleaner = cl.FileCleanerThread(str(root), retention_hours=24.0, clock=lambda: now)
        removed = cleaner.force_cleanup()
        left = sorted(str(p.relative_to(root)) for p in root.rglob("*"))
        missing = cl.FileCleanerThread(str(tmp_path / "none")).force_cleanup()
        started = (cleaner.start(), cleaner.start(), cleaner.stop(), cleaner.stop())
        return removed, left, missing, started

    got, want = both(run)
    assert got == want
    assert got[0] == (4, 400) and got[1] == ["a", "a/new.jpg", "top_new.jpg"]


# -- hardware ----------------------------------------------------------------------------


def test_hardware_probes_without_backends_equal(monkeypatch):
    monkeypatch.setitem(sys.modules, "serial", None)
    monkeypatch.setitem(sys.modules, "serial.tools", None)
    monkeypatch.setitem(sys.modules, "serial.tools.list_ports", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got, want = both(lambda *m: (m[5].find_esp32(), m[5].find_camera(),
                                 m[5].ESP32_VID, m[5].ESP32_PID, m[5].CAMERA_CANDIDATES))
    assert got == want == (None, None, 0x303A, 0x1001, ("/dev/video0", "/dev/video1",
                                                         "/dev/video2"))
