"""Cross-node time sources for training stats: a copy of
deeplearning4j_tpu/parallel/time_source.py (stdlib only; the port keeps its
own copy, since importing the JAX package imports JAX).

Equivalent of reference dl4j-spark spark/time/:
TimeSource SPI, SystemClockTimeSource (fallback), NTPTimeSource
(NTPTimeSource.java:28-69 — queries an NTP server on a refresh interval and
applies the measured offset so multi-host stats timelines align; server and
frequency configurable, system properties there, constructor args here).
The SNTP exchange is implemented directly on a UDP socket (RFC 4330 48-byte
packet); any failure falls back to the system clock, as the reference does.
"""
from __future__ import annotations

import logging
import socket
import struct
import threading
import time

log = logging.getLogger(__name__)

# seconds between NTP epoch (1900) and unix epoch (1970)
_NTP_DELTA = 2208988800


class TimeSource:
    """reference: spark/time/TimeSource.java"""

    def current_time_millis(self):
        raise NotImplementedError

    currentTimeMillis = current_time_millis


class SystemClockTimeSource(TimeSource):
    """reference: spark/time/SystemClockTimeSource.java"""

    def current_time_millis(self):
        return int(time.time() * 1000)

    currentTimeMillis = current_time_millis


def sntp_offset_millis(server, port=123, timeout=2.0):
    """One SNTP exchange -> clock offset in ms ((t1+t2)/2 - local midpoint,
    RFC 4330). Raises on any socket/parse failure."""
    packet = bytearray(48)
    packet[0] = 0x1B              # LI=0, VN=3, Mode=3 (client)
    t_send = time.time()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(timeout)
        s.sendto(bytes(packet), (server, int(port)))
        data, _ = s.recvfrom(512)
    t_recv = time.time()
    if len(data) < 48:
        raise ValueError(f"short NTP response ({len(data)} bytes)")
    # receive (32:40) and transmit (40:48) timestamps, 32.32 fixed point
    rx_s, rx_f = struct.unpack("!II", data[32:40])
    tx_s, tx_f = struct.unpack("!II", data[40:48])
    t_rx = rx_s - _NTP_DELTA + rx_f / 2**32
    t_tx = tx_s - _NTP_DELTA + tx_f / 2**32
    offset = ((t_rx - t_send) + (t_tx - t_recv)) / 2.0
    return offset * 1000.0


class NTPTimeSource(TimeSource):
    """reference: spark/time/NTPTimeSource.java — offset refreshed every
    `update_frequency_ms`; falls back to the system clock (offset 0) when
    the server can't be reached."""

    def __init__(self, server="pool.ntp.org", port=123,
                 update_frequency_ms=30 * 60 * 1000, timeout=2.0):
        self.server = server
        self.port = int(port)
        self.update_frequency_ms = int(update_frequency_ms)
        self.timeout = timeout
        self._offset_ms = 0.0
        self._last_update = 0.0
        self._refreshing = threading.Lock()   # single-flight refresh guard
        self._update()                        # first measurement is sync

    def _update(self):
        if not self._refreshing.acquire(blocking=False):
            return            # another caller is already refreshing
        try:
            self._offset_ms = sntp_offset_millis(self.server, self.port,
                                                 self.timeout)
        except Exception as e:   # reference logs + falls back to offset 0
            log.warning("NTP query to %s:%s failed (%s); using system clock",
                        self.server, self.port, e)
        finally:
            self._last_update = time.time()
            self._refreshing.release()

    def offset_millis(self):
        return self._offset_ms

    def current_time_millis(self):
        """Never blocks on the network: a due refresh is kicked off on a
        background thread (single-flight) and the current offset is used
        meanwhile — the reference's background-refresh behavior, not an
        inline 2s socket wait on the stats hot path."""
        if (time.time() - self._last_update) * 1000 > \
                self.update_frequency_ms and not self._refreshing.locked():
            threading.Thread(target=self._update, daemon=True).start()
        return int(time.time() * 1000 + self._offset_ms)

    currentTimeMillis = current_time_millis
