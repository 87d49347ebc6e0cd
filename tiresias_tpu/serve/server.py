"""TCP recognition service: JSON-lines protocol over a socket.

The reference's only runtime entry point is the Asterisk dialplan — a caller
must be bridged through a PBX to use it. This server exposes the same
recognition semantics to any client that can open a socket, one JSON object
per line:

    → {"op": "open",   "channel": "c1", "context": "media",
       "duration_ms": 3000, "tolerance": 0.01, ...}
    → {"op": "pcm",    "channel": "c1", "pcm": "<base64 int16 LE mono>"}
      (channels opened with "format": "ulaw"/"alaw" send raw G.711 trunk
       bytes instead — one byte per sample, decoded ON DEVICE; "l16" is
       the default linear int16)
    → {"op": "hangup", "channel": "c1"}
    → {"op": "echo", "payload": "..."}    (liveness/RTT probe; replies
       {"echo": payload} inline — no scorer, no device)
    ← {"channel": "c1", "result": {"TIRSTATUS": "FOUND", ...,
       "CONFIDENCE": "0.96"}}

plus a live ADMIN plane against this process's store (the reference's
CLI-inside-the-module model, /root/reference/src/cli_handler.c:26-31):

    → {"op": "admin", "cmd": "show_contexts" | "show_audios" |
       "remove_audio" | "remove_context" | "sync" | "save" | "compact" |
       "reload", ...}
    ← {"admin": {...}} | {"error": "..."}

The server owns the data directory (utils.locking single-writer flock);
the CLI auto-detects it via server.json and proxies admin commands here.

Scoring stays batched: a single scorer task drains every connection's full
windows together through :class:`StreamingRecognizer.process_ready` — many
sockets, one device pass per tick. Errors on one connection never affect
another (reference failure-isolation spirit, application_handler.c:171-176).
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import time

import numpy as np

from tiresias_tpu.utils import next_pow2
from tiresias_tpu.api.engine import SearchResult, Tiresias
from tiresias_tpu.serve.streaming import StreamingRecognizer
from tiresias_tpu.utils.logging import get_logger

log = get_logger(__name__)

SCORE_INTERVAL_S = 0.02  # scorer tick
# Batched device passes allowed in flight at once. >1 pipelines the device:
# while pass k's results are read back and attributed on the host, pass
# k+1's windows are already dispatched — the server-shaped analogue of the
# bench's
# sequential-scan pipelining. Bounded so a slow search can't pile up
# unbounded executor threads.
MAX_SCORES_IN_FLIGHT = 4
# Longest accepted protocol line. 8 MiB of base64 ≈ 6 MB of int16 PCM ≈ 6+
# minutes at 8 kHz — larger windows must arrive as multiple pcm ops. Bounds
# per-connection read-buffer memory against hostile clients.
MAX_LINE_BYTES = 8 * 2**20
# Longest the shared scorer will wait for one client's socket to drain a
# result. A peer that stops reading (full TCP receive buffer) would
# otherwise park the whole batched pass on its writer.drain() — and
# MAX_SCORES_IN_FLIGHT such peers would halt scoring for every channel on
# the server. On timeout the unresponsive connection is aborted; its
# channels hang up through the connection's own cleanup path.
DRAIN_TIMEOUT_S = 10.0


def _p50_ms(snapshot: dict, name: str) -> float | None:
    vals = sorted(snapshot["timings"].get(name, ()))
    if not vals:
        return None
    return round(vals[len(vals) // 2] * 1e3, 3)


class RecognitionServer:
    def __init__(
        self,
        engine: Tiresias,
        host: str = "127.0.0.1",
        port: int = 8517,
        samplerate: int = 8000,
        admin: str = "local",
        watch_interval: float | None = None,
        max_channels: int = 128,
        follow_interval: float | None = None,
        reload_config=None,
    ) -> None:
        """``admin``: who may issue ``op: "admin"`` mutations — ``"local"``
        (default: loopback peers only; the reference's CLI is equally
        machine-local), ``"any"`` (every peer — only behind a trusted
        network), or ``"off"``.

        ``max_channels``: hard cap on concurrently open channels across all
        connections. Also the warmup bound (run_server pre-compiles every
        power-of-two batch bucket up to it), so enforcing it guarantees no
        tick ever pads to an uncompiled batch shape — and bounds total
        per-channel buffer memory against hostile clients.

        ``watch_interval``: seconds between automatic directory re-syncs
        against the live store (None = off). The reference only syncs at
        module load (/root/reference/src/app_tiresias.c:66-123); a serving
        deployment wants media directories picked up without a restart.

        ``follow_interval``: seconds between checkpoint-refresh polls for
        a READ-ONLY replica server (None = off) — the engine must NOT own
        the data dir; the owner ingests and checkpoints, replicas swap in
        each committed generation (engine.refresh_from_checkpoint) and
        scale out read traffic."""
        if admin not in ("local", "any", "off"):
            raise ValueError("admin must be 'local', 'any', or 'off'")
        if watch_interval is not None and watch_interval <= 0:
            raise ValueError("watch_interval must be positive seconds")
        if follow_interval is not None:
            if follow_interval <= 0:
                raise ValueError("follow_interval must be positive seconds")
            if engine.lock.held:
                raise ValueError(
                    "follow mode is for read-only replicas; this engine "
                    "OWNS the data dir (its store is the source of truth)"
                )
            if watch_interval is not None:
                raise ValueError("watch and follow modes are exclusive")
        if max_channels < 1:
            raise ValueError("max_channels must be at least 1")
        self.max_channels = int(max_channels)
        self.engine = engine
        self.host = host
        self.port = port
        self.admin = admin
        self.watch_interval = watch_interval
        self.follow_interval = follow_interval
        # () -> TiresiasConfig, re-parsing the deployment's conf file —
        # the admin 'reload' op and run_server's SIGHUP both call it
        # (None: reload re-syncs under the CURRENT config)
        self._reload_config = reload_config
        self.recognizer = StreamingRecognizer(engine, samplerate=samplerate)
        self._writers: dict[str, asyncio.StreamWriter] = {}
        self._server: asyncio.AbstractServer | None = None
        self._scorer: asyncio.Task | None = None
        self._watcher: asyncio.Task | None = None
        self._follower: asyncio.Task | None = None
        self._conn_seq = 0
        # score passes currently running (shared with the hangup handler:
        # writer cleanup must wait for any pass that may still hold a
        # window of the hung-up channel)
        self._in_flight: set[asyncio.Task] = set()
        # set by the pcm handler when a push completes a window: the
        # scorer wakes immediately instead of finishing its tick — the
        # tick's mean 10 ms wait would otherwise ride on every paced
        # batch-1 recognition's completion latency
        self._score_wake = asyncio.Event()
        self._cleanups: set[asyncio.Task] = set()
        self._chan_epoch: dict[str, int] = {}
        # wire law per channel, OWNED here (not read back from the
        # recognizer per pcm op: the scorer deletes a one-shot channel's
        # state when its window is taken, and a trailing odd-length G.711
        # frame parsed as int16 would hand a well-behaved client a
        # spurious error — plus it cost a recognizer-lock hit per frame)
        self._chan_law: dict[str, str | None] = {}
        # cid -> the owning connection's `opened` set, so deferred
        # releases can free the connection-local membership too
        self._opened_ref: dict[str, set] = {}

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_client, self.host, self.port, limit=MAX_LINE_BYTES
        )
        sock = self._server.sockets[0]
        self.port = sock.getsockname()[1]  # resolve port 0
        self._scorer = asyncio.create_task(self._score_loop())
        if self.watch_interval is not None:
            self._watcher = asyncio.create_task(self._watch_loop())
        if self.follow_interval is not None:
            self._follower = asyncio.create_task(self._follow_loop())
        # advertise the admin endpoint so an offline CLI on this data dir
        # can proxy mutations here instead of racing the checkpoints
        # (reference live-CLI semantics, cli_handler.c:26-31)
        if self.engine.lock.held:
            from tiresias_tpu.utils.locking import write_server_info

            write_server_info(
                self.engine.config.expanded_data_dir, self.host, self.port
            )
            self.engine.lock.annotate(
                {"server": {"host": self.host, "port": self.port}}
            )
        log.info("recognition server listening on %s:%d", self.host, self.port)

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        # only the data-dir OWNER advertised itself in start(); a
        # read-only server instance must not delete the live owner's
        # server.json out from under the CLI's proxy detection
        if self.engine.lock.held:
            from tiresias_tpu.utils.locking import clear_server_info

            clear_server_info(self.engine.config.expanded_data_dir)
        if self._server is not None:
            self._server.close()
            # Python 3.12's wait_closed also waits for every client handler
            # to finish; connections whose peers linger would hang an
            # operator's shutdown forever — bound the wait and proceed
            # (handlers die with the process anyway)
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._server.wait_closed(), timeout=5)
        if self._scorer is not None:
            self._scorer.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._scorer
        if self._watcher is not None:
            self._watcher.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._watcher
        if self._follower is not None:
            self._follower.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._follower

    # ------------------------------------------------------------------ #

    async def _score_loop(self) -> None:
        in_flight = self._in_flight
        try:
            while True:
                # event-driven with the tick as fallback: a completed
                # window wakes the pass immediately; timer-paced work
                # (continuous-mode slides, stragglers) still runs at
                # SCORE_INTERVAL_S
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(
                        self._score_wake.wait(), SCORE_INTERVAL_S
                    )
                try:
                    self._score_wake.clear()
                    if len(in_flight) >= MAX_SCORES_IN_FLIGHT:
                        # every pass slot busy: sleep again — the
                        # done-callback below re-sets the wake when a
                        # slot frees, so a window that completed during
                        # saturation dispatches the moment a pass ends,
                        # not after the remaining tick. Windows that
                        # complete while passes are in flight coalesce
                        # into the NEXT pass (_take_ready batches
                        # everything ready), so load keeps the old
                        # tick-batched amortization.
                        continue
                    if not self.recognizer.has_ready():
                        # nothing to take (idle tick, or a done-callback
                        # wake that found the ready set already drained):
                        # skip the executor round trip entirely
                        continue
                    # device work off the event loop so slow searches don't
                    # stall IO; NOT awaited here — up to MAX_SCORES_IN_FLIGHT
                    # batched passes pipeline through the device (_take_ready
                    # hands each pass disjoint windows under the lock)
                    task = asyncio.create_task(self._score_once())
                    in_flight.add(task)

                    def _done(t, in_flight=in_flight):
                        in_flight.discard(t)
                        # a slot freed: re-check for windows that went
                        # ready while we were saturated
                        self._score_wake.set()

                    task.add_done_callback(_done)
                except Exception:  # noqa: BLE001 - the scorer must never die
                    log.exception("score loop iteration failed; continuing")
        finally:
            # stop() cancellation usually lands on the sleep above — the
            # finally (not an except around the create_task) is what
            # actually reaches the in-flight passes
            for task in in_flight:
                task.cancel()

    async def _score_once(self) -> None:
        try:
            results = await asyncio.get_running_loop().run_in_executor(
                None, self.recognizer.process_ready
            )
            for channel_id, result in results.items():
                await self._send_result(channel_id, result)
                if not self.recognizer.is_open(channel_id):
                    # a one-shot channel closed with its final window:
                    # free its writer/opened entries like a hangup would
                    # (after any still-in-flight earlier windows drain)
                    self._schedule_channel_release(channel_id)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            log.exception("score pass failed; continuing")

    async def _watch_loop(self) -> None:
        """Periodic directory re-sync against the live store (watch mode).
        Runs in the executor so a large ingest never stalls the event
        loop; ticks are serial — a sync still in progress just delays the
        next one. Sync failures (e.g. an unreadable directory) log and
        the watcher continues: serving must outlive media hiccups."""
        loop = asyncio.get_running_loop()

        def tick():
            report = self.engine.sync()
            if report.created or report.deleted:
                # rebuild any derived search maps the mutation dropped,
                # HERE, while no other mutation can race the lock-free
                # build (ticks are serial and admin syncs hold the same
                # mutexed paths) — a build racing a concurrent append
                # would land on a stale view and be repaid every search
                self.engine.warm_search_maps()
            return report

        while True:
            await asyncio.sleep(self.watch_interval)
            try:
                report = await loop.run_in_executor(None, tick)
                if report.created or report.deleted:
                    log.info(
                        "watch sync: +%d -%d audios",
                        report.created, report.deleted,
                    )
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - the watcher must never die
                log.exception("watch sync failed; continuing")

    async def _follow_loop(self) -> None:
        """Replica follow: poll the owner's checkpoint and swap in newer
        generations (engine.refresh_from_checkpoint). Runs off the event
        loop; a failed refresh logs and keeps serving the current store."""
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.follow_interval)
            try:
                refreshed = await loop.run_in_executor(
                    None, self.engine.refresh_from_checkpoint
                )
                if refreshed:
                    log.info(
                        "follow: now serving %d audios",
                        len(self.engine.store),
                    )
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 - the follower must never die
                log.exception("follow refresh failed; continuing")

    async def _send_result(self, channel_id: str, result: SearchResult) -> None:
        # never pops: several pipelined passes may each deliver a window
        # for a now-closed channel (the protocol promises delivery of every
        # dispatched window, in any order) — popping on the first delivery
        # would drop the rest. Release is the hangup handler's deferred
        # cleanup (after in-flight passes finish) or the connection's
        # finally-block on disconnect.
        writer = self._writers.get(channel_id)
        if writer is None or writer.is_closing():
            return
        payload = result.to_channel_vars()
        payload["CONFIDENCE"] = f"{result.confidence:.4f}"
        try:
            writer.write(
                (json.dumps({"channel": self._public_id(channel_id),
                             "window": result.window,
                             "result": payload}) + "\n").encode()
            )
            # bounded: this coroutine runs inside a shared batched pass —
            # one unresponsive peer must not stall every other channel's
            # delivery or pin an in-flight slot forever
            await asyncio.wait_for(writer.drain(), DRAIN_TIMEOUT_S)
        except ConnectionError:
            pass
        except asyncio.TimeoutError:
            log.warning(
                "client for channel %s stopped reading; dropping connection",
                self._public_id(channel_id),
            )
            writer.transport.abort()

    @staticmethod
    def _public_id(internal_id: str) -> str:
        return internal_id.split("|", 1)[1]

    def _schedule_channel_release(self, channel_id: str) -> None:
        """Free a finished channel's writer/opened entries once the score
        passes in flight right now have drained (hangup op, or a one-shot
        channel's final window delivered)."""
        pending = {t for t in self._in_flight if not t.done()}
        epoch = self._chan_epoch.get(channel_id, 0)

        async def release():
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            # the same connection may have RE-opened the same channel id
            # while we waited (epoch bumped) — that incarnation's own
            # finish schedules its own release; this one stands down
            if (
                self._chan_epoch.get(channel_id, 0) == epoch
                and not self.recognizer.is_open(channel_id)
            ):
                self._writers.pop(channel_id, None)
                self._chan_epoch.pop(channel_id, None)
                self._chan_law.pop(channel_id, None)
                opened = self._opened_ref.pop(channel_id, None)
                if opened is not None:
                    opened.discard(channel_id)

        task = asyncio.get_running_loop().create_task(release())
        self._cleanups.add(task)
        task.add_done_callback(self._cleanups.discard)

    async def _handle_client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._conn_seq += 1
        conn = self._conn_seq
        opened: set[str] = set()
        admin_ok = self._admin_allowed(writer)

        def cid(channel: str) -> str:
            # connection-scoped channel ids: two clients may both say "c1"
            return f"{conn}|{channel}"

        try:
            while True:
                try:
                    line = await reader.readline()
                except ValueError:
                    # line exceeded MAX_LINE_BYTES; the stream cannot be
                    # resynced mid-line — answer once and drop the connection
                    writer.write(
                        (json.dumps({"error": "line too long"}) + "\n").encode()
                    )
                    await writer.drain()
                    # the client may STILL be sending the oversized line;
                    # closing now leaves unread bytes in our receive buffer
                    # and the kernel answers with RST, which can destroy
                    # the error line before the client reads it (observed
                    # under a loaded 128-channel soak). Discard the rest of
                    # the line — bounded — so the close FINs cleanly and
                    # the error is actually deliverable.
                    try:
                        discarded = 0
                        while discarded < 8 * MAX_LINE_BYTES:
                            chunk = await asyncio.wait_for(
                                reader.read(2**20), timeout=5.0
                            )
                            if not chunk:
                                break
                            discarded += len(chunk)
                            if chunk.endswith(b"\n"):
                                break
                    except (TimeoutError, asyncio.TimeoutError, OSError):
                        pass  # peer misbehaving harder: just close
                    break
                if not line:
                    break
                try:
                    msg = json.loads(line)
                    op = msg["op"]
                    channel = str(msg.get("channel", ""))
                    await self._dispatch_op(
                        op, channel, msg, cid, opened, writer, admin_ok
                    )
                except ConnectionError:
                    raise
                except Exception as exc:  # noqa: BLE001 - bad request only
                    # any malformed request (bad JSON, missing keys, invalid
                    # base64, wrong types) answers {"error": ...} and never
                    # kills the connection or its other channels
                    writer.write(
                        (json.dumps({"error": f"bad request: {exc}"}) + "\n").encode()
                    )
                    await writer.drain()
        except ConnectionError:
            pass
        finally:
            # a dropped socket mid-recognition is a hangup (reference
            # semantics: channel death before duration → HANGUP, no search);
            # no flush — there is no one left to deliver a result to
            for channel_id in opened:
                self._writers.pop(channel_id, None)
                self._chan_epoch.pop(channel_id, None)
                self._chan_law.pop(channel_id, None)
                self._opened_ref.pop(channel_id, None)
                self.recognizer.hangup(channel_id, flush=False)
            writer.close()

    def _admin_allowed(self, writer) -> bool:
        """Admin-plane authorization by peer address (the reference's CLI
        runs only on the local machine; same trust model by default)."""
        if self.admin == "any":
            return True
        if self.admin == "off":
            return False
        peer = writer.get_extra_info("peername")
        host = peer[0] if peer else ""
        return host in ("127.0.0.1", "::1", "::ffff:127.0.0.1")

    async def _dispatch_op(
        self, op, channel, msg, cid, opened, writer, admin_ok=True
    ) -> None:
        if op == "open":
            if self.recognizer.n_channels >= self.max_channels:
                # enforce the warmed/advertised capacity: channels past it
                # would pad the scorer to uncompiled batch shapes (a
                # multi-second stall for everyone) and buffer unbounded PCM
                writer.write(
                    (json.dumps({
                        "error": f"server at channel capacity "
                                 f"({self.max_channels})",
                        "code": "at_capacity",
                    }) + "\n").encode()
                )
                await writer.drain()
                return
            kwargs = {
                k: msg[k]
                for k in (
                    "context",
                    "duration_ms",
                    "tolerance",
                    "coefs",
                    "freq_ignore_low",
                    "freq_ignore_high",
                    "trunc_coef1",
                    "aligned",
                    "filter_context",
                    "continuous",
                    "hop_ms",
                )
                if k in msg
            }
            fmt = msg.get("format", "l16")
            from tiresias_tpu.utils.g711 import WIRE_FORMATS

            if fmt not in WIRE_FORMATS:
                raise ValueError(
                    f"unknown format {fmt!r} (expected one of "
                    f"{WIRE_FORMATS})"
                )
            if fmt != "l16":
                kwargs["law"] = fmt
            try:
                self.recognizer.open(cid(channel), **kwargs)
            except ValueError as exc:
                # recognizer errors name the connection-scoped id
                # ("7|c1"); the client must see its own channel name
                raise ValueError(
                    str(exc).replace(repr(cid(channel)), repr(channel))
                ) from None
            self._writers[cid(channel)] = writer
            self._chan_law[cid(channel)] = kwargs.get("law")
            # re-opening the same id invalidates any pending post-hangup
            # release for the previous incarnation (see
            # _schedule_channel_release)
            self._chan_epoch[cid(channel)] = (
                self._chan_epoch.get(cid(channel), 0) + 1
            )
            self._opened_ref[cid(channel)] = opened
            opened.add(cid(channel))
            writer.write(
                (json.dumps({"channel": channel, "opened": True}) + "\n").encode()
            )
            await writer.drain()
        elif op == "pcm":
            raw = base64.b64decode(msg["pcm"], validate=True)
            if self._chan_law.get(cid(channel)) is not None:
                pcm = np.frombuffer(raw, dtype=np.uint8)  # G.711 bytes
            else:
                pcm = np.frombuffer(raw, dtype="<i2")
            if self.recognizer.push(cid(channel), pcm):
                self._score_wake.set()  # full window: wake the scorer now
        elif op == "echo":
            # minimal wire round-trip: socket IO + JSON parse + inline
            # reply on the event loop, touching neither the scorer nor
            # the device. Load balancers use it as a liveness probe and
            # the bench as the TCP-floor term of its latency
            # decomposition (bench.py server section).
            writer.write(
                (json.dumps({"echo": msg.get("payload", "")}) + "\n")
                .encode()
            )
            await writer.drain()
        elif op == "stats":
            from tiresias_tpu.utils.tracing import metrics

            def snap_stats():
                # len(store) takes the store-wide RLock — off the event
                # loop so a long-held lock (compact/save in an executor
                # thread) can't freeze every connection's IO
                snap = metrics.snapshot()
                return {
                    "channels": self.recognizer.n_channels,
                    "audios": len(self.engine.store),
                    # checkpoint generation being served: lets an operator
                    # confirm a --follow replica has caught up to the
                    # owner (_restored_gen covers replicas, whose save
                    # generation is never advanced)
                    "generation": max(
                        self.engine.store._save_gen,
                        self.engine.store._restored_gen,
                    ),
                    "owner": self.engine.lock.held,
                    "counters": snap["counters"],
                    "search_p50_ms": _p50_ms(snap, "search.match"),
                }

            stats = await asyncio.get_running_loop().run_in_executor(
                None, snap_stats
            )
            writer.write((json.dumps({"stats": stats}) + "\n").encode())
            await writer.drain()
        elif op == "hangup":
            # off the event loop: hangup may flush-score a complete window
            # (a device search — milliseconds to seconds), which must not
            # stall every other connection's IO
            result = await asyncio.get_running_loop().run_in_executor(
                None, self.recognizer.hangup, cid(channel)
            )
            if result is not None:
                await self._send_result_direct(writer, channel, result)
            elif cid(channel) not in opened:
                # a hangup for a channel this connection never opened gets
                # an explicit error — silence would block a write-then-read
                # client until its socket timeout
                writer.write(
                    (json.dumps({"error": f"unknown channel {channel!r}"})
                     + "\n").encode()
                )
                await writer.drain()
            # Release the writer mapping only after every score pass that
            # was in flight AT HANGUP TIME has finished: such a pass may
            # still hold an earlier window of this channel, and the
            # protocol's window counter promises delivery in any order.
            # Passes started after the hangup cannot take windows from a
            # closed channel, so waiting on this snapshot is sufficient —
            # and a long-lived connection's per-call channels are freed
            # instead of accumulating until disconnect.
            self._schedule_channel_release(cid(channel))
        elif op == "admin":
            # live admin plane: CRUD/sync against THIS process's store —
            # the reference's CLI-inside-the-module operational model
            # (/root/reference/src/cli_handler.c:26-31). Mutations persist
            # via the engine's own checkpoint (it owns the data-dir lock).
            # Gated by peer address (self.admin) — recognition may be
            # exposed to a network; destructive admin must not be.
            reply = (
                await self._dispatch_admin(msg)
                if admin_ok
                else {"error": "admin not permitted from this peer",
                      "code": "not_permitted"}
            )
            writer.write((json.dumps(reply) + "\n").encode())
            await writer.drain()
        else:
            writer.write(
                (json.dumps({"error": f"unknown op {op!r}"}) + "\n").encode()
            )
            await writer.drain()

    # admin commands that write the store and/or the checkpoint — they
    # require this server to actually OWN the data dir, or a read-only
    # replica would mutate its in-memory view, fail the save, and silently
    # diverge from what the live owner serves
    _MUTATING_ADMIN = ("remove_audio", "remove_context", "sync", "save",
                       "compact", "reload")

    async def _dispatch_admin(self, msg: dict) -> dict:
        cmd = msg.get("cmd")
        eng = self.engine
        loop = asyncio.get_running_loop()

        def in_executor(fn):
            return loop.run_in_executor(None, fn)

        if cmd in self._MUTATING_ADMIN and not eng.lock.held:
            return {
                "error": "server is read-only: another process owns this "
                         "data directory; send the mutation to the owner",
                "code": "read_only",
            }
        # reads also go through the executor: they take the store-wide
        # RLock, which long operations (compact's memmove, save's full
        # checkpoint write) hold for seconds from executor threads — a
        # blocking acquire HERE would freeze the event loop for every
        # connection
        if cmd == "show_contexts":
            return {"admin": {"contexts": await in_executor(
                eng.get_contexts
            )}}
        if cmd == "show_audios":
            context = str(msg["context"])
            from tiresias_tpu.serve.admin import audio_row

            def read_rows():
                if eng.store.get_context(context) is None:
                    return None
                return [audio_row(a) for a in eng.get_audios(context)]

            rows = await in_executor(read_rows)
            if rows is None:
                return {"error": f"unknown context {context!r}",
                        "code": "unknown_context"}
            return {"admin": {"audios": rows}}
        if cmd == "remove_audio":
            uuid = str(msg["uuid"])

            def work():
                removed = eng.delete_audio(uuid)
                if removed:
                    eng.save()
                return removed

            return {"admin": {"removed": bool(await in_executor(work))}}
        if cmd == "remove_context":
            name = str(msg["context"])

            def work():
                removed = eng.delete_context(name)
                if removed:
                    eng.save()
                return removed

            return {"admin": {"removed": bool(await in_executor(work))}}
        if cmd == "reload":
            # live config reload (the reference declines reload outright —
            # unload/load required, /root/reference/src/app_tiresias.c:
            # 608-614): re-parse the conf file, adopt it, re-sync. DSP or
            # data_dir changes are rejected by engine.reload and the old
            # config keeps serving.
            def work():
                new_cfg = (
                    self._reload_config() if self._reload_config else None
                )
                report = eng.reload(new_cfg)
                eng.warm_search_maps()
                return report, [c["name"] for c in eng.get_contexts()]

            try:
                report, contexts = await in_executor(work)
            except Exception as exc:  # noqa: BLE001 - bad conf must not kill serving
                log.exception("config reload failed; keeping the old config")
                return {"error": f"reload failed: {exc}",
                        "code": "bad_config"}
            return {"admin": {"reloaded": True, "contexts": contexts,
                              "sync": vars(report)}}
        if cmd == "sync":
            context = msg.get("context")

            def work():
                # engine.sync/sync_context hold the engine's sync mutex:
                # an admin sync never interleaves with a watch-mode tick
                # walking the same directories
                if context is None:
                    report = eng.sync()
                else:
                    report = eng.sync_context(str(context))
                # rebuild any derived maps the ingest invalidated while
                # no other mutation can race the build (ticks serialize)
                eng.warm_search_maps()
                return report

            try:
                report = await in_executor(work)
            except ValueError as exc:
                return {"error": str(exc), "code": "unknown_context"}
            return {"admin": {"sync": {
                "created": report.created, "deduped": report.deduped,
                "deleted": report.deleted, "failed": report.failed,
            }}}
        if cmd == "search":
            # one-shot recognition against the LIVE store — the dialplan
            # app's operational model (runs in the owning process,
            # /root/reference/src/application_handler.c:180) without a
            # per-invocation cold engine restore. Read-only: allowed on
            # read-only replicas too. PCM arrives base64 int16 like the
            # streaming protocol; per-call knobs mirror search_pcm.
            # ``queries`` (a list of {pcm, dtype, samplerate}) answers a
            # whole table in ONE round trip and one batched device pass
            # per samplerate — the CLI's multi-file proxy path.
            queries = msg.get("queries")
            single = queries is None
            if single:
                queries = [msg]
            if not queries or not isinstance(queries, list):
                return {"error": "queries must be a non-empty list",
                        "code": "bad_request"}
            # validate the cheap parameters BEFORE paying the base64
            # decode of up to MAX_LINE_BYTES of PCM
            top = msg.get("top")
            if top is not None:
                if not single:
                    return {"error": "top supports a single query",
                            "code": "bad_request"}
                if (isinstance(top, bool) or not isinstance(top, int)
                        or not 1 <= top <= 1024):
                    return {"error": "top must be an int in [1, 1024]",
                            "code": "bad_request"}
            pcms: list = []
            for q in queries:
                raw = base64.b64decode(q["pcm"], validate=True)
                if len(raw) > MAX_LINE_BYTES:
                    return {"error": "pcm too large", "code": "too_large"}
                # dtype "f32" carries float PCM unquantized (the CLI proxy
                # uses it so a proxied search is bit-identical to offline
                # for >16-bit sources); default stays int16 like the pcm op
                qd = q.get("dtype", "i16")
                if qd == "f32":
                    pcm = np.frombuffer(raw, dtype="<f4")
                elif qd in ("ulaw", "alaw"):
                    # one-shot G.711 payload: expand on host (bit-identical
                    # to the device table gather, utils/g711.py) — half the
                    # base64 bytes of i16 for trunk recordings
                    from tiresias_tpu.utils.g711 import decode

                    pcm = decode(raw, qd)
                elif qd == "i16":
                    pcm = np.frombuffer(raw, dtype="<i2")
                else:
                    # an unknown dtype silently parsed as i16 would return
                    # confidently wrong results — reject per request
                    return {"error": f"unknown dtype {qd!r} (expected "
                            "f32, i16, ulaw, or alaw)",
                            "code": "bad_request"}
                pcms.append((
                    pcm,
                    int(q.get("samplerate", self.recognizer.samplerate)),
                ))
            kwargs = {
                k: msg[k]
                for k in (
                    "coefs", "tolerance", "freq_ignore_low",
                    "freq_ignore_high", "trunc_coef1", "aligned",
                    "filter_context", "min_margin",
                )
                if k in msg
            }
            context = msg.get("context")
            if top is not None:
                # ranked top-N listing (CLI --top) from the live store;
                # bounded like the engine's candidate budget so a typo
                # can't demand a million-row table (validated above)

                def work_top():
                    return eng.search_pcm_topk(
                        context, pcms[0][0], pcms[0][1], k=top, **kwargs
                    )

                ranked = await in_executor(work_top)
                return {"admin": {"ranked": [
                    dict(r.to_channel_vars(),
                         CONFIDENCE=f"{r.confidence:.4f}")
                    for r in ranked
                ]}}

            def work():
                if single:
                    return [eng.search_pcm(
                        context, pcms[0][0], pcms[0][1], **kwargs
                    )]
                # group by samplerate: one batched device pass per rate
                # (mirrors the offline CLI's search_pcm_batch design)
                by_rate: dict[int, list[int]] = {}
                for i, (_, sr) in enumerate(pcms):
                    by_rate.setdefault(sr, []).append(i)
                out: list = [None] * len(pcms)
                for sr, idxs in sorted(by_rate.items()):
                    batch = eng.search_pcm_batch(
                        context, [pcms[i][0] for i in idxs], sr, **kwargs
                    )
                    for i, res in zip(idxs, batch):
                        out[i] = res
                return out

            results = await in_executor(work)
            payloads = []
            for result in results:
                payload = result.to_channel_vars()
                payload["CONFIDENCE"] = f"{result.confidence:.4f}"
                payloads.append(payload)
            if single:
                return {"admin": {"result": payloads[0]}}
            return {"admin": {"results": payloads}}
        if cmd == "save":
            await in_executor(eng.save)
            return {"admin": {"saved": True}}
        if cmd == "compact":
            def work():
                eng.store.compact()
                eng.save()
                # compaction rebuilds the device views, dropping their
                # derived maps — rebuild them here so the next search
                # doesn't stall (and no mutation can race the build)
                eng.warm_search_maps()

            await in_executor(work)
            return {"admin": {"compacted": True}}
        return {"error": f"unknown admin cmd {cmd!r}"}

    async def _send_result_direct(
        self, writer: asyncio.StreamWriter, channel: str, result: SearchResult
    ) -> None:
        payload = result.to_channel_vars()
        payload["CONFIDENCE"] = f"{result.confidence:.4f}"
        try:
            writer.write(
                (json.dumps({"channel": channel, "window": result.window,
                             "result": payload}) + "\n").encode()
            )
            await writer.drain()
        except ConnectionError:
            pass


def warmup_batch_sizes(max_channels: int) -> tuple[int, ...]:
    """The power-of-two batch buckets the scorer actually pads to
    (StreamingRecognizer.process_ready, via the same next_pow2 rule):
    1, 2, 4, ... up to next_pow2(max_channels)."""
    top = next_pow2(max_channels)
    sizes = []
    b = 1
    while b <= top:
        sizes.append(b)
        b *= 2
    return tuple(sizes)


def run_server(
    engine: Tiresias, host: str = "127.0.0.1", port: int = 8517,
    samplerate: int = 8000, max_channels: int = 128, admin: str = "local",
    watch_interval: float | None = None, follow_interval: float | None = None,
    warm_laws: tuple[str, ...] = (),
    reload_config=None,
) -> None:
    """Blocking entry point (the `tiresias serve` CLI command).

    Warms EVERY power-of-two batch bucket up to ``max_channels`` before
    accepting connections — the scorer pads each tick to these shapes, so a
    full house of channels on the first tick must find its executable
    compiled (the persistent compilation cache makes this near-instant on
    every restart after the first).

    The engine's lifecycle is owned here: on return (including SIGTERM /
    Ctrl-C) the server stops accepting, the engine checkpoints and its
    data-dir lock is released — the unload-time term()/fp_term sequence
    of the reference (/root/reference/src/app_tiresias.c:125-149)."""

    async def main():
        import signal

        # readiness-tiered warmup (round 5): only the int16 bucket
        # programs — the TCP wire format — block the accept loop; f32
        # buckets and warm_laws' G.711 device-decode programs compile on
        # a background thread while the scorer host-expands law windows
        # to int16 (bit-identical, PARITY D18 / engine.law_device_ready).
        # Cold start to READY is ~a third of the full warm bill.
        t0 = time.monotonic()
        warm_thread = engine.warmup_async(
            samplerate=samplerate,
            batch_sizes=warmup_batch_sizes(max_channels),
            laws=warm_laws,
        )
        log.info(
            "ready: int16 search buckets warmed in %.1fs "
            "(f32%s warming in background)",
            time.monotonic() - t0,
            " + laws " + ",".join(warm_laws) if warm_laws else "",
        )
        del warm_thread  # daemon; readiness does not wait for it
        server = RecognitionServer(
            engine, host, port, samplerate, admin=admin,
            watch_interval=watch_interval, max_channels=max_channels,
            follow_interval=follow_interval, reload_config=reload_config,
        )
        await server.start()
        stop_ev = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop_ev.set)
            except (NotImplementedError, RuntimeError):
                pass  # non-unix, or not the main thread (library use)

        def on_hup():
            # kill -HUP <pid>: live config reload, the classic daemon
            # convention (the reference requires a module unload/load,
            # /root/reference/src/app_tiresias.c:608-614). Routed through
            # the same admin handler the protocol uses: read-only
            # replicas refuse, a bad conf logs and keeps the old one.
            async def do():
                res = await server._dispatch_admin({"cmd": "reload"})
                if "error" in res:
                    log.error("SIGHUP reload refused: %s", res["error"])
                else:
                    log.info("SIGHUP reload: %s", res["admin"])

            loop.create_task(do())

        try:
            loop.add_signal_handler(signal.SIGHUP, on_hup)
        except (NotImplementedError, RuntimeError, AttributeError):
            pass  # non-unix, or not the main thread (library use)
        # flush: parents watch for this banner over a (block-buffered) pipe
        print(f"tiresias serving on {server.host}:{server.port}", flush=True)
        serve_task = asyncio.create_task(server.serve_forever())
        stop_task = asyncio.create_task(stop_ev.wait())
        await asyncio.wait(
            {serve_task, stop_task}, return_when=asyncio.FIRST_COMPLETED
        )
        log.info("shutting down")
        await server.stop()
        for task in (serve_task, stop_task):
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task

    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass  # signal handler unavailable (e.g. Windows) — still close below
    finally:
        engine.close()
