"""The durable parameter server: round journal, outer-state checkpoint,
recovery (counterpart of the parameter-server half of
``hypha_tpu/ft/durable.py``).

Everything lives under the job's ``checkpoint_dir``:

  * :class:`RoundJournal` — a write-ahead log of the round protocol:
    ``gen`` (one per server start: the **generation id** workers detect a
    restart by), ``open``, one ``fold`` per accepted delta (peer, round,
    fragment, sample weight, the wire file's sha-256; the saved files
    under ``deltas/`` are the payload), ``close``, ``commit`` after the
    outer step and ``notified`` after the scheduler's answer. Records are
    length-prefixed (u32 little-endian) CBOR through the port's codec,
    the reference's bytes, so a journal written by either package parses
    in the other record for record; ``$HYPHA_JOURNAL_FSYNC_EVERY`` batches
    the fsyncs (``gen``, ``commit`` and ``notified`` always sync); a torn
    tail reads as the end of the log.
  * the **outer-state checkpoint** — a SafeTensors snapshot of momentum,
    the rejoin catch-up Σ and the broadcast error-feedback residuals
    (``momentum/``, ``catchup/``, ``ef/<fragment>/`` names), with the next
    round, the membership epoch and each fragment's newest broadcast in
    ``ps-state.json`` (written beside, then renamed: the commit point).
    Written every ``ps_checkpoint_every_rounds`` commits; the journal is
    then compacted to the records the snapshot does not cover.
  * :class:`DurablePS` — recovery. On restart it loads the
    checkpoint and hands the executor the committed rounds after it (their
    outer steps re-run from the journaled folds, in arrival order: bit for
    bit) and the interrupted round's folds. The journal's (round,
    fragment, peer, sha) index makes a worker's re-send idempotent.

The reference's ``FT_METRICS`` counters are telemetry, not ported
(ROADMAP.md, Queue 1: telemetry): the journal counts its records and bytes
and the server counts its dedup hits on the objects, and the executor logs
them. The scheduler's journal (``DurableScheduler``) belongs to
**scheduler recovery** and is not ported.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import struct
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable

from .. import codec
from ..executor.serialization import load_file, read_header, save_file

__all__ = [
    "GENERATION_KEY",
    "RESYNC_KEY",
    "JOURNAL_FSYNC_ENV",
    "RoundJournal",
    "DurablePS",
    "FoldRecord",
    "restart_signal",
]

log = logging.getLogger("hypha.torch.ft.durable")

# Push/broadcast header key carrying the server's process generation: a
# worker that sees it change re-sends its last un-acknowledged delta.
GENERATION_KEY = "ps_generation"

# Header key of the empty restart announcement a recovered server pushes on
# the results stream ("I am generation g: re-send what I have not
# journaled"), needed when a crash came before the first commit.
RESYNC_KEY = "ps_resync"

# Fsync every N appends (default 1); <= 0 disables fsync entirely.
JOURNAL_FSYNC_ENV = "HYPHA_JOURNAL_FSYNC_EVERY"

# A record longer than this is a torn length prefix, not a record.
_MAX_RECORD = 1 << 20

_JOURNAL_NAME = "journal.cbor"
_STATE_POINTER = "ps-state.json"


def _fsync_every() -> int:
    try:
        return int(os.environ.get(JOURNAL_FSYNC_ENV, "1") or 1)
    except ValueError:
        return 1


def restart_signal(meta: dict, last_gen: Any) -> tuple:
    """``(generation to remember, re-send?)`` from one results-stream
    header: re-send on a generation bump, or on an explicit resync (a
    worker that never saw a broadcast has no baseline)."""
    gen = meta.get(GENERATION_KEY)
    resync = bool(meta.get(RESYNC_KEY))
    if gen is None:
        return last_gen, resync
    return gen, resync or (last_gen is not None and gen != last_gen)


class RoundJournal:
    """Append-only, length-prefixed CBOR record log with batched fsync."""

    def __init__(self, path: "Path | str", fsync_every: "int | None" = None) -> None:
        self.path = Path(path)
        self.fsync_every = _fsync_every() if fsync_every is None else fsync_every
        self._f = open(self.path, "ab")
        self._since_sync = 0
        self.bytes_written = 0
        self.records_written = 0

    def append(self, record: dict, *, sync: bool = False) -> None:
        body = codec.dumps(record)
        frame = struct.pack("<I", len(body)) + body
        self._f.write(frame)
        self.bytes_written += len(frame)
        self.records_written += 1
        self._since_sync += 1
        self._f.flush()
        if sync or (0 < self.fsync_every <= self._since_sync):
            if self.fsync_every > 0:
                os.fsync(self._f.fileno())
            self._since_sync = 0

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._since_sync = 0

    def close(self) -> None:
        try:
            self._f.flush()
        finally:
            self._f.close()

    def replace_with(self, records: Iterable) -> None:
        """Compact: atomically rewrite the log to just ``records``."""
        tmp = self.path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            for record in records:
                body = codec.dumps(record)
                f.write(struct.pack("<I", len(body)) + body)
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        self._since_sync = 0

    @staticmethod
    def read_all(path: "Path | str") -> list:
        """Parse the log; a torn tail (a crash mid-append) ends it cleanly."""
        records: list = []
        try:
            data = Path(path).read_bytes()
        except OSError:
            return records
        off = 0
        while off + 4 <= len(data):
            (length,) = struct.unpack_from("<I", data, off)
            if length > _MAX_RECORD or off + 4 + length > len(data):
                break
            try:
                record = codec.loads(data[off + 4:off + 4 + length])
            except ValueError:
                break
            if not isinstance(record, dict):
                break
            records.append(record)
            off += 4 + length
        return records


@dataclass(slots=True)
class FoldRecord:
    """One accepted delta, as the journal remembers it. ``peer`` is the
    round table's key (``prefold:<sender>`` for a tree-reduce partial);
    ``prefold`` and ``covers`` mark a partial and the workers it covers, so
    a replay re-derives the un-folds the live collector made for it."""

    round: int
    fragment: int
    peer: str
    samples: float
    sha: str
    file: str
    prefold: bool = False
    covers: list = field(default_factory=list)

    def record(self) -> dict:
        rec = {"t": "fold", "round": self.round, "fragment": self.fragment, "peer": self.peer,
               "samples": self.samples, "sha": self.sha, "file": self.file}
        if self.prefold:
            rec["prefold"] = True
            rec["covers"] = list(self.covers)
        return rec


@dataclass(slots=True)
class _Resume:
    """What recovery hands back to the executor."""

    next_round: int
    epoch: int
    active: list
    catchup_rounds: int
    fragment_rounds: dict
    state_file: "str | None"
    committed: list = field(default_factory=list)  # commit records after the snapshot
    notified: dict = field(default_factory=dict)


class DurablePS:
    """The parameter server's durable state root. :meth:`open` (blocking:
    run it off the event loop) appends this process's ``gen`` record and,
    when the directory holds state of the SAME job id, parses checkpoint
    and journal into a :class:`_Resume`. State of another job id is wiped
    (a full job restart runs under a new id)."""

    def __init__(self, root: Path, job_id: str, ckpt_every: int = 1,
                 fsync_every: "int | None" = None, owned=None) -> None:
        self.root = Path(root)
        self.job_id = job_id
        self.ckpt_every = max(int(ckpt_every), 1)
        # A stream shard closes only the rounds whose due fragment it owns:
        # ``owned(round)`` tells the contiguity check and the checkpoint
        # cadence which rounds are its own (None: every round).
        self._owned = owned
        self.deltas_dir = self.root / "deltas"
        self.wires_dir = self.root / "wires"
        self.generation = 1
        self.resume: "_Resume | None" = None
        self.journal: RoundJournal
        self._dedup: dict = {}  # (round, fragment, peer) -> sha folded
        self._folds: dict = {}  # round -> [FoldRecord] in arrival order
        self._last_wire: dict = {}  # fragment -> (round, wire file name)
        self._window: list = []  # records the checkpoint does not cover
        self._ckpt_next_round = 0
        self._commits_since_ckpt = 0
        self.dedup_hits = 0

    # ------------------------------------------------------------- opening

    @classmethod
    def open(cls, root: "Path | str", job_id: str, ckpt_every: int = 1,
             fsync_every: "int | None" = None, owned=None) -> "DurablePS":
        dur = cls(Path(root), job_id, ckpt_every, fsync_every, owned=owned)
        dur.root.mkdir(parents=True, exist_ok=True)
        dur.deltas_dir.mkdir(exist_ok=True)
        dur.wires_dir.mkdir(exist_ok=True)
        meta = dur._read_pointer()
        if meta is not None and meta.get("job_id") != job_id:
            log.info("durable ps state at %s belongs to job %s; starting fresh",
                     dur.root, meta.get("job_id"))
            dur._wipe()
            meta = None
        records = RoundJournal.read_all(dur.root / _JOURNAL_NAME)
        if meta is None and records:
            stamps = [r for r in records if r.get("t") == "gen"]
            if not stamps or stamps[0].get("job_id") != job_id:
                dur._wipe()
                records = []
        dur.journal = RoundJournal(dur.root / _JOURNAL_NAME, fsync_every)
        # The max of every recorded generation, not a count: compaction
        # keeps a single gen record.
        prev_gen = max((int(r.get("generation", 0)) for r in records if r.get("t") == "gen"),
                       default=0)
        if meta is not None:
            prev_gen = max(prev_gen, int(meta.get("generation", 0)))
        dur.generation = prev_gen + 1
        dur.journal.append({"t": "gen", "generation": dur.generation, "job_id": job_id},
                           sync=True)
        if meta is not None or records:
            dur.resume = dur._build_resume(meta, records)
            dur._gc_unreferenced()
        return dur

    def _gc_unreferenced(self) -> None:
        """Drop files a crash stranded between a checkpoint and its cleanup."""
        live_deltas = {fold.file for folds in self._folds.values() for fold in folds}
        for f in self.deltas_dir.glob("*"):
            if f.name not in live_deltas:
                f.unlink(missing_ok=True)
        live_wires = {name for _, name in self._last_wire.values()}
        for f in self.wires_dir.glob("*"):
            if f.name not in live_wires:
                f.unlink(missing_ok=True)
        keep_state = self.resume.state_file if self.resume else None
        for f in self.root.glob("state-*.safetensors"):
            if f.name != keep_state:
                f.unlink(missing_ok=True)

    def _read_pointer(self) -> "dict | None":
        try:
            return json.loads((self.root / _STATE_POINTER).read_text())
        except (OSError, ValueError):
            return None

    def _wipe(self) -> None:
        for name in (_JOURNAL_NAME, _STATE_POINTER):
            (self.root / name).unlink(missing_ok=True)
        for d in (self.deltas_dir, self.wires_dir):
            for f in d.glob("*"):
                f.unlink(missing_ok=True)
        for f in self.root.glob("state-*.safetensors"):
            f.unlink(missing_ok=True)

    def _build_resume(self, meta: "dict | None", records: list) -> _Resume:
        meta = meta or {}
        resume = _Resume(
            next_round=int(meta.get("next_round", 0)),
            epoch=int(meta.get("epoch", 0)),
            active=list(meta.get("active", [])),
            catchup_rounds=int(meta.get("catchup_rounds", 0)),
            fragment_rounds={(None if k == "-" else int(k)): v
                             for k, v in (meta.get("fragment_rounds") or {}).items()},
            state_file=meta.get("state_file"),
        )
        self._ckpt_next_round = resume.next_round
        for frag, (rnd, name) in (meta.get("last_wires") or {}).items():
            self._last_wire[int(frag)] = (int(rnd), str(name))
        committed: dict = {}
        for rec in records:
            t = rec.get("t")
            if t == "fold":
                rnd = int(rec.get("round", -1))
                if rnd < resume.next_round:
                    continue  # covered by the checkpoint
                fold = FoldRecord(
                    round=rnd, fragment=int(rec.get("fragment", 0)), peer=str(rec.get("peer", "")),
                    samples=float(rec.get("samples", 1.0)), sha=str(rec.get("sha", "")),
                    file=str(rec.get("file", "")), prefold=bool(rec.get("prefold", False)),
                    covers=[str(p) for p in rec.get("covers", [])])
                self._folds.setdefault(rnd, []).append(fold)
                self._dedup[(rnd, fold.fragment, fold.peer)] = fold.sha
                self._window.append(rec)
            elif t == "commit":
                rnd = int(rec.get("round", -1))
                frag = int(rec.get("fragment", 0))
                wire = str(rec.get("wire", ""))
                prev = self._last_wire.get(frag)
                if prev is None or rnd > prev[0]:
                    self._last_wire[frag] = (rnd, wire)
                if rnd >= resume.next_round:
                    committed[rnd] = rec
                    self._window.append(rec)
            elif t == "notified":
                rnd = int(rec.get("round", -1))
                resume.notified[rnd] = bool(rec.get("done", False))
                if rnd >= resume.next_round:
                    self._window.append(rec)
        resume.committed = [committed[r] for r in sorted(committed)]
        # Committed rounds must run on from the checkpoint: a gap is journal
        # loss, and skipping an outer step silently is refused. A stream
        # shard's journal skips the rounds it does not own.
        expect = resume.next_round
        for rec in resume.committed:
            if self._owned is not None:
                guard = expect + 4096  # a malformed owned() must not spin
                while expect < guard and not self._owned(expect):
                    expect += 1
            if int(rec["round"]) != expect:
                raise ValueError(f"durable ps journal gap: commit for round {rec['round']} but "
                                 f"checkpoint resumes at {expect}")
            expect += 1
        return resume

    # -------------------------------------------------------------- folding

    def already_folded(self, round_num: int, fragment: int, peer: str, sha: str) -> bool:
        """True when this exact delta is in the journal (a worker's re-send
        after a restart, or a retried push whose first copy landed)."""
        hit = self._dedup.get((round_num, fragment, peer)) == sha
        if hit:
            self.dedup_hits += 1
        return hit

    def note_fold(self, fold: FoldRecord, *, sync: bool = False) -> None:
        self._folds.setdefault(fold.round, []).append(fold)
        self._dedup[(fold.round, fold.fragment, fold.peer)] = fold.sha
        rec = fold.record()
        self._window.append(rec)
        self.journal.append(rec, sync=sync)

    def note_open(self, round_num: int) -> None:
        self.journal.append({"t": "open", "round": round_num})

    def note_close(self, round_num: int, peers: list) -> None:
        self.journal.append({"t": "close", "round": round_num, "peers": sorted(peers)})

    def note_notified(self, round_num: int, done: bool) -> None:
        rec = {"t": "notified", "round": round_num, "done": done}
        self._window.append(rec)
        self.journal.append(rec, sync=True)

    def folds_for(self, round_num: int) -> list:
        """The round's journaled folds, the LAST send per peer winning, in
        the order of the winning records."""
        latest: dict = {}
        for fold in self._folds.get(round_num, []):
            latest[fold.peer] = fold
        order = {id(f): i for i, f in enumerate(self._folds.get(round_num, []))}
        return sorted(latest.values(), key=lambda f: order[id(f)])

    def replay_ops(self, round_num: int) -> list:
        """The exact (record, sign) fold sequence that built the round's
        accumulator: +1 per record in arrival order, preceded by a -1
        un-fold of the record it replaced, and, before a tree-reduce
        partial, the un-folds the collector's ``_retire_covered`` made for
        it (first every other sender's partial its covers intersect, then
        its members' direct deltas, each loop in sorted order). Float
        addition is order sensitive: re-applying THIS sequence makes a
        recovered outer step bit-equal to the crashed process's. A
        superseded file that is gone drops its +/- pair instead (last-wins,
        ulp-level drift)."""
        ops: list = []
        last: dict = {}

        def unfold(prev: FoldRecord) -> None:
            if (self.deltas_dir / prev.file).is_file():
                ops.append((prev, -1.0))
            else:
                ops[:] = [op for op in ops if not (op[0] is prev and op[1] > 0)]

        for fold in self._folds.get(round_num, []):
            prev = last.get(fold.peer)
            if prev is not None:
                unfold(prev)
            if fold.prefold and fold.covers:
                covset = frozenset(fold.covers)
                for okey in sorted(last):
                    oprev = last[okey]
                    if okey == fold.peer or not oprev.prefold:
                        continue
                    if frozenset(oprev.covers or ()) & covset:
                        unfold(oprev)
                        del last[okey]
                for member in sorted(fold.covers):
                    mprev = last.get(member)
                    if mprev is not None and not mprev.prefold:
                        unfold(mprev)
                        del last[member]
            ops.append((fold, 1.0))
            last[fold.peer] = fold
        return ops

    def pending_rounds(self, from_round: int) -> list:
        """Rounds >= ``from_round`` with journaled folds."""
        return sorted(r for r in self._folds if r >= from_round)

    # ------------------------------------------------------------ committing

    def wire_path(self, round_num: int) -> Path:
        return self.wires_dir / f"wire-{round_num}.safetensors"

    def store_wire(self, round_num: int, wire_src: Path) -> str:
        """Keep one round's broadcast wire for a restart's re-send
        (hard-linked on one filesystem, copied otherwise); its name."""
        dest = self.wire_path(round_num)
        tmp = dest.with_suffix(".tmp")
        tmp.unlink(missing_ok=True)
        try:
            os.link(wire_src, tmp)
        except OSError:
            shutil.copyfile(wire_src, tmp)
        os.replace(tmp, dest)
        return dest.name

    def newest_commit(self, fragment: int) -> int:
        """Round of the fragment's newest committed broadcast (-1: none)."""
        return self._last_wire.get(fragment, (-1, ""))[0]

    def last_wires(self) -> list:
        """(round, fragment, path) of each fragment's newest committed
        broadcast, in round order: what recovery re-broadcasts."""
        out = []
        for frag, (rnd, name) in self._last_wire.items():
            path = self.wires_dir / name
            if path.is_file():
                out.append((rnd, frag, path))
        return sorted(out)

    def commit_round(self, round_num: int, fragment: int, wire_name: str, *, epoch: int,
                     momentum_file, catchup=None, efs: "dict | None" = None,
                     active: "list | None" = None) -> None:
        """Durably commit one outer step (blocking: run it off the loop).
        The checkpoint, when due, lands BEFORE the commit record, so every
        journaled commit has a snapshot at or before it. ``momentum_file``
        is one file or a list whose later files override earlier names."""
        prev = self._last_wire.get(fragment)
        self._last_wire[fragment] = (round_num, wire_name)
        # One server keeps the round-parity rule; a shard owning only some
        # rounds counts its own commits (parity might never fire for it).
        self._commits_since_ckpt += 1
        due = ((round_num + 1) % self.ckpt_every == 0 if self._owned is None
               else self._commits_since_ckpt >= self.ckpt_every)
        if due:
            self._checkpoint(next_round=round_num + 1, epoch=epoch, momentum_file=momentum_file,
                             catchup=catchup, efs=efs or {}, active=active or [])
        rec = {"t": "commit", "round": round_num, "fragment": fragment, "wire": wire_name,
               "epoch": epoch}
        self._window.append(rec)
        self.journal.append(rec, sync=True)
        if prev is not None and prev[1] != wire_name:
            (self.wires_dir / prev[1]).unlink(missing_ok=True)

    def _checkpoint(self, *, next_round: int, epoch: int, momentum_file, catchup,
                    efs: dict, active: list) -> None:
        t0 = time.perf_counter()
        tensors: dict = {}
        # One file, or the pipelined loop's base and its parts over it.
        files = momentum_file if isinstance(momentum_file, (list, tuple)) else [momentum_file]
        for path in files:
            if Path(path).is_file():
                for key, value in load_file(path).items():
                    tensors[f"momentum/{key}"] = value
        catchup_rounds = 0
        fragment_rounds: dict = {}
        if catchup is not None:
            cum, catchup_rounds, fragment_rounds = catchup.state()
            for key, value in cum.items():
                tensors[f"catchup/{key}"] = value
        for frag, ef in efs.items():
            if ef is None:
                continue
            for key, value in ef.state().items():
                tensors[f"ef/{frag}/{key}"] = value
        state_file = f"state-{next_round}.safetensors"
        tmp = self.root / (state_file + ".tmp")
        save_file(dict(sorted(tensors.items())), tmp)
        with open(tmp, "rb+") as f:
            os.fsync(f.fileno())
        os.replace(tmp, self.root / state_file)
        meta = {
            "job_id": self.job_id,
            "next_round": next_round,
            "epoch": epoch,
            "active": list(active),
            "catchup_rounds": catchup_rounds,
            "fragment_rounds": {("-" if k is None else str(k)): v
                                for k, v in fragment_rounds.items()},
            "state_file": state_file,
            "generation": self.generation,
            "last_wires": {str(frag): [rnd, name] for frag, (rnd, name) in self._last_wire.items()},
        }
        pointer_tmp = self.root / (_STATE_POINTER + ".tmp")
        pointer_tmp.write_text(json.dumps(meta, indent=1))
        with open(pointer_tmp, "rb+") as f:
            os.fsync(f.fileno())
        os.replace(pointer_tmp, self.root / _STATE_POINTER)  # THE commit point
        old_next = self._ckpt_next_round
        self._ckpt_next_round = next_round
        self._commits_since_ckpt = 0
        for f in self.root.glob("state-*.safetensors"):
            if f.name != state_file:
                f.unlink(missing_ok=True)
        for rnd in [r for r in self._folds if r < next_round]:
            for fold in self._folds.pop(rnd):
                (self.deltas_dir / fold.file).unlink(missing_ok=True)
                self._dedup.pop((rnd, fold.fragment, fold.peer), None)
        self._window = [r for r in self._window if int(r.get("round", -1)) >= next_round]
        self.journal.replace_with(
            [{"t": "gen", "generation": self.generation, "job_id": self.job_id}] + self._window)
        log.info("durable ps checkpoint: next_round %d -> %d (%d tensors, %d bytes in %.3f s, "
                 "journal window %d records) under %s", old_next, next_round, len(tensors),
                 (self.root / state_file).stat().st_size, time.perf_counter() - t0,
                 len(self._window), self.root.name)

    # ------------------------------------------------------------- recovery

    def restore_momentum(self, momentum_file: Path) -> None:
        tensors = self._state_tensors("momentum/")
        if tensors:
            tmp = momentum_file.with_suffix(".tmp")
            save_file(tensors, tmp)
            os.replace(tmp, momentum_file)
        else:
            momentum_file.unlink(missing_ok=True)

    def restore_catchup(self, catchup) -> None:
        assert self.resume is not None
        catchup.restore(self._state_tensors("catchup/"), self.resume.catchup_rounds,
                        self.resume.fragment_rounds)

    def restore_efs(self) -> dict:
        """fragment id -> residual tree (empty without a snapshot)."""
        out: dict = {}
        for key, value in self._state_tensors("ef/").items():
            frag, name = key.split("/", 1)
            out.setdefault(int(frag), {})[name] = value
        return out

    def _state_tensors(self, prefix: str) -> dict:
        """The snapshot's tensors under ``prefix`` (reading only those),
        keyed without it; empty without a snapshot."""
        if self.resume is None or self.resume.state_file is None:
            return {}
        path = self.root / self.resume.state_file
        if not path.is_file():
            return {}
        names = [k for k in read_header(path)[0] if k.startswith(prefix)]
        return {k[len(prefix):]: v for k, v in load_file(path, names).items()}

    def close(self) -> None:
        self.journal.close()
