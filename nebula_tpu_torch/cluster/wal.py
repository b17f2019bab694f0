"""The port's copy of `nebula_tpu/cluster/wal.py`, whole.

File-based write-ahead log, one per Raft part.

Analog of the reference's FileBasedWal + AtomicLogBuffer (reference:
src/kvstore/wal): an append-only
record log with (term, index, payload) entries, CRC-checked, truncatable
from the tail (log rollback after leader change) and from the head
(snapshot GC).

Group commit: `append_batch` writes a whole request's frames
with ONE buffered write, one flush, one fsync; and the fsync itself is
a *group sync* — `sync_to(index)` is a coalescing point where the
first caller's fsync covers every entry flushed before it started, so
concurrent proposers on one part share a single durability round
instead of queueing one fsync each.

Record format (little-endian):
    u32 crc32(payload_len..payload) | u32 payload_len | u64 index |
    u64 term | payload bytes
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Iterator, List, Optional, Tuple

_HDR = struct.Struct("<IIQQ")          # crc, len, index, term


class WalError(Exception):
    pass


class Wal:
    """Append-only (term, index, data) log with in-memory index."""

    def __init__(self, path: str, sync: bool = False):
        self.path = path
        self.sync = sync
        from ..utils.racecheck import make_lock
        self.lock = make_lock("wal")
        # serializes fsyncs (the group-sync coalescing point) and file
        # close/reopen against an in-flight fsync.  Lock order is ALWAYS
        # _sync_mu → lock; nothing takes _sync_mu while holding lock.
        self._sync_mu = make_lock("wal_sync")
        # last index known durable (covered by an fsync).  Meaningful
        # only when sync=True; async logs report last_index() as synced.
        self._synced_upto = 0
        self._entries: List[Tuple[int, int, int]] = []  # (index, term, offset)
        self._first_index = 1
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._recover()
        self._synced_upto = (self._entries[-1][0] if self._entries
                             else self._first_index - 1)
        self._f = open(self.path, "ab")
        # cached read handle: the apply/replication paths read entries
        # one at a time — an open() per read turns a 512-entry batch
        # apply into 512 file opens per node (measured ~300ms); the
        # shared handle is seek/read under `lock` and invalidated on
        # any file swap (truncate/reset/compact)
        self._rf = None

    # -- recovery ---------------------------------------------------------

    def _recover(self):
        if not os.path.exists(self.path):
            return
        good_end = 0
        with open(self.path, "rb") as f:
            data = f.read()
        off = 0
        while off + _HDR.size <= len(data):
            crc, ln, idx, term = _HDR.unpack_from(data, off)
            end = off + _HDR.size + ln
            if end > len(data):
                break
            payload = data[off + _HDR.size:end]
            calc = zlib.crc32(_HDR.pack(0, ln, idx, term)[4:] + payload)
            if calc != crc:
                break                   # torn tail write — truncate here
            self._entries.append((idx, term, off))
            good_end = end
            off = end
        if good_end < len(data):
            with open(self.path, "r+b") as f:
                f.truncate(good_end)
        if self._entries:
            self._first_index = self._entries[0][0]

    # -- append / read ----------------------------------------------------

    def append(self, index: int, term: int, data: bytes):
        self.append_batch([(index, term, data)])

    def append_batch(self, entries: List[Tuple[int, int, bytes]],
                     sync: Optional[bool] = None):
        """Append contiguous (index, term, data) entries with ONE
        buffered write, one flush, and — when the log is synchronous —
        one fsync for the whole batch (the single-fsync leg of group
        commit; the reference's per-entry fsync is the cost this
        amortizes).

        sync=False defers durability: the caller later invokes
        `sync_to(last_index)` OUTSIDE its own locks so concurrent
        appenders can coalesce onto one fsync."""
        if not entries:
            return
        with self.lock:
            if self._entries:
                last = self._entries[-1][0]
            else:
                # first entry anchors the index base (e.g. the log
                # restarts at snap_index+1 after a snapshot install)
                self._first_index = entries[0][0]
                last = entries[0][0] - 1
            buf = bytearray()
            off = self._f.tell()
            new = []
            for index, term, data in entries:
                if index != last + 1:
                    raise WalError(
                        f"non-contiguous append {index} after {last}")
                last = index
                hdr_rest = _HDR.pack(0, len(data), index, term)[4:]
                crc = zlib.crc32(hdr_rest + data)
                new.append((index, term, off + len(buf)))
                buf += _HDR.pack(crc, len(data), index, term)
                buf += data
            self._f.write(buf)
            self._f.flush()
            self._entries.extend(new)
        if (self.sync if sync is None else sync) and self.sync:
            self.sync_to(last)

    def synced_index(self) -> int:
        """Last index covered by an fsync (== last_index() for async
        logs).  The raft leader only replicates entries it has made
        durable locally, preserving the pre-group-commit invariant that
        a follower never holds an entry the leader could lose."""
        if not self.sync:
            return self.last_index()
        return self._synced_upto

    def sync_to(self, index: int):
        """Make all entries up to `index` durable.  Group sync: callers
        pile up on `_sync_mu`; whoever holds it fsyncs once, covering
        every entry flushed before the fsync started, and the waiters
        find their index already covered when they get the lock."""
        if not self.sync or self._synced_upto >= index:
            return
        with self._sync_mu:
            if self._synced_upto >= index:
                return                 # a sibling's fsync covered us
            # armed `delay` = an fsync stall (held under _sync_mu, so it
            # stalls the whole group-commit sync like a slow disk does);
            # armed `raise` = a disk fault — propagates like a real
            # fsync error would
            from ..utils.failpoints import fail as _fail
            _fail.hit("wal:pre_fsync", key=self.path)
            with self.lock:
                flushed = (self._entries[-1][0] if self._entries
                           else self._first_index - 1)
                f = self._f
            try:
                os.fsync(f.fileno())
            except (OSError, ValueError):
                with self.lock:
                    swapped = f is not self._f or f.closed
                if swapped:
                    # file swapped under us (truncate/reset on
                    # step-down): the entry's fate belongs to the new
                    # leader anyway
                    return
                # genuine disk fault (EIO/ENOSPC): must PROPAGATE like
                # the old per-entry fsync did — swallowing it would
                # leave the proposer timing out against a healthy-
                # looking leader while the fault goes unreported (and
                # a later fsync could falsely mark the lost pages
                # durable)
                from ..utils.stats import stats
                stats().inc("wal_fsync_errors")
                raise
            covered = flushed - self._synced_upto
            self._synced_upto = flushed
            from ..utils.stats import current_cost, stats
            stats().inc("wal_fsync_total")
            if covered > 0:
                stats().inc("wal_fsync_batch_entries", covered)
            # cost attribution: the request whose thread ran
            # the group fsync carries it in its reply cost record
            # (coalesced siblings ride free — documented approximation)
            cc = current_cost()
            if cc is not None:
                cc.add("wal_fsyncs", 1)

    def last_index(self) -> int:
        with self.lock:
            return self._entries[-1][0] if self._entries else self._first_index - 1

    def last_term(self) -> int:
        with self.lock:
            return self._entries[-1][1] if self._entries else 0

    def first_index(self) -> int:
        return self._first_index

    def term_of(self, index: int) -> Optional[int]:
        with self.lock:
            i = index - self._first_index
            if 0 <= i < len(self._entries):
                return self._entries[i][1]
            return None

    def read(self, index: int) -> Optional[Tuple[int, bytes]]:
        """-> (term, data) or None."""
        with self.lock:
            i = index - self._first_index
            if not (0 <= i < len(self._entries)):
                return None
            _, term, off = self._entries[i]
            if self._rf is None or self._rf.closed:
                self._rf = open(self.path, "rb")
            f = self._rf
            f.seek(off)
            hdr = f.read(_HDR.size)
            _, ln, idx, t = _HDR.unpack(hdr)
            return t, f.read(ln)

    def _drop_read_handle(self):
        """Called (under lock) whenever the underlying file is swapped."""
        if self._rf is not None:
            try:
                self._rf.close()
            except OSError:
                pass
            self._rf = None

    def read_range(self, start: int, end: int) -> Iterator[Tuple[int, int, bytes]]:
        """Yield (index, term, data) for start <= index <= end."""
        for idx in range(max(start, self._first_index),
                         min(end, self.last_index()) + 1):
            r = self.read(idx)
            if r is None:
                return
            yield idx, r[0], r[1]

    # -- truncation -------------------------------------------------------

    def truncate_from(self, index: int):
        """Drop entries >= index (conflicting suffix after leader change)."""
        with self._sync_mu, self.lock:
            i = index - self._first_index
            if i < 0:
                i = 0
            if i >= len(self._entries):
                return
            off = self._entries[i][2]
            self._f.close()
            self._drop_read_handle()
            with open(self.path, "r+b") as f:
                f.truncate(off)
            self._f = open(self.path, "ab")
            del self._entries[i:]
            self._synced_upto = min(self._synced_upto, index - 1)

    def reset(self, first_index: int):
        """Clear the log and restart it at first_index (after a snapshot
        install replaces all local state)."""
        with self._sync_mu, self.lock:
            self._f.close()
            self._drop_read_handle()
            with open(self.path, "wb"):
                pass
            self._f = open(self.path, "ab")
            self._entries = []
            self._first_index = first_index
            self._synced_upto = first_index - 1

    def compact_to(self, index: int):
        """Drop entries <= index (after snapshot). Rewrites the file."""
        with self._sync_mu, self.lock:
            keep = [(i, t, o) for (i, t, o) in self._entries if i > index]
            self._f.close()
            self._drop_read_handle()
            tmp = self.path + ".compact"
            with open(tmp, "wb") as out, open(self.path, "rb") as src:
                new_entries = []
                for idx, term, off in keep:
                    src.seek(off)
                    hdr = src.read(_HDR.size)
                    _, ln, _, _ = _HDR.unpack(hdr)
                    new_off = out.tell()
                    out.write(hdr)
                    out.write(src.read(ln))
                    new_entries.append((idx, term, new_off))
            os.replace(tmp, self.path)
            self._entries = new_entries
            self._first_index = index + 1 if not new_entries else new_entries[0][0]
            self._f = open(self.path, "ab")
            # compacted entries were applied state — at least as durable
            # as the snapshot that subsumed them
            self._synced_upto = max(self._synced_upto, index)

    def close(self):
        with self._sync_mu, self.lock:
            self._f.close()
            self._drop_read_handle()
