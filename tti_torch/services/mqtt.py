"""MQTT liveness heartbeat, a host daemon thread (copy of
``tti.services.mqtt``).

Publishes payload "on" QoS 0 every interval to machine/{device}/status/heartbeat
— identical wire behavior to the reference (mqtt_heartbeat.py:7-46,
config.py:181-183): TLS client on 8883, optional insecure mode, 1-10 s
reconnect backoff.

The client is injectable; when paho-mqtt is absent the heartbeat degrades to a
no-op publisher with a warning (the system must keep measuring without its
side channels — reference: main.py:153-154).
"""

from __future__ import annotations

import threading

from typing import Any, Callable

from tti_torch.core.config import MqttConfig
from tti_torch.core.logging import get_logger

log = get_logger("services.mqtt")


class NullClient:
    """Publisher of last resort: counts messages, goes nowhere."""

    def __init__(self) -> None:
        self.published = 0

    def connect(self, *a, **k) -> None: ...

    def loop_start(self) -> None: ...

    def loop_stop(self) -> None: ...

    def disconnect(self) -> None: ...

    def publish(self, topic: str, payload: str, qos: int = 0, retain: bool = False) -> None:
        self.published += 1


def _make_paho_client(cfg: MqttConfig):
    import ssl

    import paho.mqtt.client as mqtt  # optional dependency

    client = mqtt.Client(client_id=f"{cfg.topic.replace('/', '_')}_hb")
    if cfg.username:
        client.username_pw_set(cfg.username, cfg.password)
    client.tls_set(tls_version=ssl.PROTOCOL_TLS_CLIENT)
    if cfg.tls_insecure:
        client.tls_insecure_set(True)
    client.reconnect_delay_set(min_delay=1, max_delay=10)
    return client


class MqttHeartbeat(threading.Thread):
    def __init__(
        self,
        config: MqttConfig,
        client_factory: Callable[[MqttConfig], Any] | None = None,
    ) -> None:
        super().__init__(daemon=True, name="tti-mqtt-heartbeat")
        self.config = config
        self._stop_event = threading.Event()
        if client_factory is not None:
            self.client = client_factory(config)
        else:
            try:
                self.client = _make_paho_client(config)
            except ImportError:
                log.warning("paho-mqtt not installed; heartbeat runs as no-op")
                self.client = NullClient()

    def run(self) -> None:
        try:
            self.client.connect(self.config.server or "localhost", self.config.port, 30)
            self.client.loop_start()
        except Exception as e:
            log.warning("mqtt connect failed: %s (heartbeat thread exiting)", e)
            return
        try:
            while not self._stop_event.is_set():
                try:
                    self.client.publish(self.config.topic, payload="on", qos=0, retain=False)
                except Exception as e:
                    log.warning("heartbeat publish failed: %s", e)
                self._stop_event.wait(self.config.interval_s)
        finally:
            self.client.loop_stop()
            self.client.disconnect()

    def stop(self) -> None:
        self._stop_event.set()
