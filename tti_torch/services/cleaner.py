"""Retention cleaner for the annotated-frame trail (copy of
``tti.services.cleaner``).

Same behavior as the reference's FileCleanerThread (file_cleaner.py:11-141):
hourly recursive sweep deleting files older than 24 h, bottom-up walk removing
emptied session directories, 1 s-granularity stoppable sleep,
``start()/stop()/force_cleanup()`` API.

Differences: injectable clock for tests; structured logging instead of prints.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

from tti_torch.core.logging import get_logger

log = get_logger("services.cleaner")


class FileCleanerThread:
    def __init__(
        self,
        directory: str,
        retention_hours: float = 24.0,
        check_interval_s: float = 3600.0,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.directory = directory
        self.retention_hours = retention_hours
        self.check_interval_s = check_interval_s
        self.clock = clock
        self.running = False
        self._thread: threading.Thread | None = None

    def _delete_old_files(self) -> tuple[int, int]:
        """Returns (files_deleted, bytes_freed)."""
        if not os.path.exists(self.directory):
            log.debug("cleanup skipped: directory not found -> %s", self.directory)
            return 0, 0
        cutoff = self.clock() - self.retention_hours * 3600.0
        deleted_files = 0
        deleted_bytes = 0
        # Bottom-up so emptied session dirs can be removed (reference:
        # file_cleaner.py:49-77).
        for root, _, files in os.walk(self.directory, topdown=False):
            for filename in files:
                path = os.path.join(root, filename)
                try:
                    mtime = os.path.getmtime(path)
                except OSError as e:
                    log.warning("could not stat %s: %s", path, e)
                    continue
                if mtime < cutoff:
                    try:
                        size = os.path.getsize(path)
                        os.remove(path)
                        deleted_files += 1
                        deleted_bytes += size
                    except OSError as e:
                        log.warning("failed deleting %s: %s", path, e)
            if root != self.directory:
                try:
                    if not os.listdir(root):
                        os.rmdir(root)
                except OSError:
                    pass  # raced or non-empty
        if deleted_files:
            log.info(
                "cleanup removed %d files (%.2f MB)", deleted_files, deleted_bytes / 2**20
            )
        return deleted_files, deleted_bytes

    def _loop(self) -> None:
        while self.running:
            self._delete_old_files()
            # Sleep in 1 s slices for responsive shutdown (reference:
            # file_cleaner.py:98-101).
            for _ in range(int(self.check_interval_s)):
                if not self.running:
                    break
                time.sleep(1)
        log.debug("file cleaner thread stopped")

    def start(self) -> bool:
        if self.running:
            return False
        self.running = True
        self._thread = threading.Thread(target=self._loop, daemon=True, name="tti-cleaner")
        self._thread.start()
        return True

    def stop(self) -> bool:
        if not self.running:
            return False
        self.running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        return True

    def force_cleanup(self) -> tuple[int, int]:
        return self._delete_old_files()
