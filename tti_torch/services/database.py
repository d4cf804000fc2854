"""Measurement persistence with the reference's DatabaseHandler contract
(copy of ``tti.services.database``).

Public API mirrors the reference exactly (reference: database.py:9-191):
``connect() / insert_measurement(total_distance, stitch_length, seam_allowance)
/ get_last_record_date() / get_last_record_total_distance() /
get_latest_measurement() / delete_measurements(timestamp) / close()`` plus
context-manager support, reconnect-on-insert and rollback-on-error.

Two backends behind one class:
- 'mysql' — production parity (mysql-connector, optional import),
- 'sqlite' — same schema/semantics in-process, used for local runs and tests
  (SURVEY.md §4: "in-memory/sqlite DB stub").

Schema (reference's commented DDL, database.py:49-57):
  id INTEGER PK AUTOINCREMENT, timestamp DATETIME(3),
  stitch_length, seam_allowance, total_distance
"""

from __future__ import annotations

import sqlite3
from datetime import date, datetime
from typing import Any

from tti_torch.core.config import DatabaseConfig
from tti_torch.core.logging import get_logger

log = get_logger("services.db")


class DatabaseHandler:
    def __init__(self, config: DatabaseConfig | None = None) -> None:
        self.config = config or DatabaseConfig()
        self.connection: Any = None
        self.cursor: Any = None

    @property
    def table(self) -> str:
        return self.config.table or "measurements"

    # -- connection ----------------------------------------------------------

    def connect(self) -> bool:
        try:
            if self.config.backend == "mysql":
                import mysql.connector  # optional dependency

                self.connection = mysql.connector.connect(
                    host=self.config.host,
                    user=self.config.user,
                    password=self.config.password,
                    database=self.config.database,
                )
                self.cursor = self.connection.cursor()
            else:
                self.connection = sqlite3.connect(
                    self.config.sqlite_path, check_same_thread=False
                )
                self.cursor = self.connection.cursor()
                self._ensure_table()
            log.info(
                "database connected (%s/%s)",
                self.config.backend,
                self.config.database or self.config.sqlite_path,
            )
            return True
        except Exception as e:
            log.warning("database connection failed: %s", e)
            self.connection = None
            self.cursor = None
            return False

    def _is_connected(self) -> bool:
        if self.connection is None:
            return False
        if self.config.backend == "mysql":
            try:
                return bool(self.connection.is_connected())
            except Exception:
                return False
        return True

    def _ensure_table(self) -> None:
        """sqlite only: create the reference schema if absent."""
        self.cursor.execute(
            f"""CREATE TABLE IF NOT EXISTS "{self.table}" (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                timestamp TEXT NOT NULL,
                stitch_length REAL,
                seam_allowance REAL,
                total_distance REAL
            )"""
        )
        self.connection.commit()

    def _placeholder(self) -> str:
        return "%s" if self.config.backend == "mysql" else "?"

    # -- queries (reference contract) -----------------------------------------

    def get_last_record_date(self) -> date | None:
        """Date of the newest record (reference: database.py:34-45)."""
        try:
            self.cursor.execute(
                f'SELECT timestamp FROM "{self.table}" ORDER BY timestamp DESC LIMIT 1'
                if self.config.backend != "mysql"
                else f"SELECT timestamp FROM `{self.table}` ORDER BY timestamp DESC LIMIT 1"
            )
            row = self.cursor.fetchone()
            if not row:
                return None
            ts = row[0]
            if isinstance(ts, str):
                ts = datetime.fromisoformat(ts)
            return ts.date()
        except Exception as e:
            log.warning("could not fetch last record date: %s", e)
            return None

    def get_last_record_total_distance(self) -> float | None:
        """Total distance of the newest record — the checkpoint the orchestrator
        resumes from (reference: database.py:68-79, main.py:168)."""
        try:
            self.cursor.execute(
                f'SELECT total_distance FROM "{self.table}" ORDER BY timestamp DESC LIMIT 1'
                if self.config.backend != "mysql"
                else f"SELECT total_distance FROM `{self.table}` ORDER BY timestamp DESC LIMIT 1"
            )
            row = self.cursor.fetchone()
            return float(row[0]) if row else None
        except Exception as e:
            log.warning("could not fetch last total distance: %s", e)
            return None

    def insert_measurement(
        self, total_distance: float, stitch_length: float, seam_allowance: float
    ) -> bool:
        """Insert with ms-precision timestamp, reconnect-on-demand and rollback
        on failure (reference: database.py:81-122)."""
        if not self._is_connected():
            if not self.connect():
                return False
        timestamp = datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")[:-3]
        p = self._placeholder()
        quoted = f"`{self.table}`" if self.config.backend == "mysql" else f'"{self.table}"'
        query = (
            f"INSERT INTO {quoted} (timestamp, stitch_length, seam_allowance, total_distance) "
            f"VALUES ({p}, {p}, {p}, {p})"
        )
        try:
            self.cursor.execute(
                query,
                (timestamp, float(stitch_length), float(seam_allowance), float(total_distance)),
            )
            self.connection.commit()
            log.debug(
                "db insert",
                extra={
                    "tti_total": total_distance,
                    "tti_length": stitch_length,
                    "tti_seam": seam_allowance,
                },
            )
            return True
        except Exception as e:
            log.warning("database insert failed: %s", e)
            try:
                self.connection.rollback()
            except Exception:
                pass
            return False

    def get_latest_measurement(self) -> dict | None:
        """Most recent row as a dict (reference: database.py:125-152)."""
        if not self._is_connected():
            if not self.connect():
                return None
        quoted = f"`{self.table}`" if self.config.backend == "mysql" else f'"{self.table}"'
        try:
            self.cursor.execute(
                f"SELECT id, timestamp, stitch_length, seam_allowance, total_distance "
                f"FROM {quoted} ORDER BY timestamp DESC LIMIT 1"
            )
            row = self.cursor.fetchone()
            if not row:
                return None
            return {
                "id": row[0],
                "timestamp": row[1],
                "stitch_length": row[2],
                "seam_allowance": row[3],
                "total_distance": row[4],
            }
        except Exception as e:
            log.warning("query failed: %s", e)
            return None

    def delete_measurements(self, timestamp) -> bool:
        """Delete by timestamp (reference: database.py:154-174)."""
        if not self._is_connected():
            if not self.connect():
                return False
        p = self._placeholder()
        quoted = f"`{self.table}`" if self.config.backend == "mysql" else f'"{self.table}"'
        try:
            self.cursor.execute(f"DELETE FROM {quoted} WHERE timestamp = {p}", (timestamp,))
            self.connection.commit()
            return True
        except Exception as e:
            log.warning("delete failed: %s", e)
            try:
                self.connection.rollback()
            except Exception:
                pass
            return False

    def close(self) -> None:
        if self.cursor is not None:
            try:
                self.cursor.close()
            except Exception:
                pass
        if self.connection is not None and self._is_connected():
            self.connection.close()
        log.info("database connection closed")

    def __enter__(self) -> "DatabaseHandler":
        self.connect()
        return self

    def __exit__(self, *exc) -> None:
        self.close()
