"""Production-style soak test: many live TCP clients against `serve`.

Reproduces the soak reported in docs/performance.md: N concurrent socket
clients stream real-time-paced 20 ms frames of a known corpus tone into a
RecognitionServer, each on a continuous window, and every scored window is
checked against the clip the client is actually playing.

Run (defaults: 128 channels, 60 s, 3 s window / 1.5 s hop):

    python tools/soak.py [--channels 128] [--seconds 60] [--hop-ms 1500]

Prints one summary line:

    soak: <windows> windows, <correct_pct>% correct, <rate>/s sustained,
    <errors> errors

The corpus is synthetic tones (like tests/test_server.py) so correctness
is unambiguous: a window is "correct" when TIRSTATUS=FOUND names the
client's own clip. Windows spanning a clip's loop seam may legitimately
mismatch — the loop is seamless for pure tones, so any miss here is real.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import socket
import sys
import tempfile
import threading
import time

import numpy as np

import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tiresias_tpu.api import Tiresias
from tiresias_tpu.config import MatchConfig, TiresiasConfig
from tiresias_tpu.serve.server import RecognitionServer, warmup_batch_sizes
from tiresias_tpu.utils.audio import float_to_i16, synth_tone

SR = 8000
FRAME_MS = 20
N_CLIPS = 16


def build_engine(wire: str = "l16") -> Tiresias:
    eng = Tiresias(
        TiresiasConfig(
            match=MatchConfig(coefs=2, tolerance=0.01, trunc_coef1=False),
            data_dir=tempfile.mkdtemp(prefix="tir_soak"),
        ),
        restore=False,
    )
    eng.create_context("m")
    for i in range(N_CLIPS):
        i16 = float_to_i16(synth_tone(250 + 130 * i, 3.0, SR))
        if wire != "l16":
            # a G.711 deployment's DB is built from trunk recordings —
            # store the companded-decoded clip so wire queries self-match
            # at the strict tolerance (pure tones differ by less than
            # companding noise otherwise)
            from tiresias_tpu.utils.g711 import decode, encode

            i16 = decode(encode(i16, wire), wire)
        eng.add_audio_pcm("m", f"tone{i}", i16.astype(np.float32) / 32768.0, SR)
    return eng


def client(
    port: int,
    channel: int,
    clip: int,
    seconds: float,
    duration_ms: int,
    hop_ms: int,
    stats: dict,
    lock: threading.Lock,
    wire: str = "l16",
) -> None:
    i16 = float_to_i16(synth_tone(250 + 130 * clip, 3.0, SR)).astype("<i2")
    if wire != "l16":
        # G.711 trunk bytes on the wire (half the int16 base64 payload);
        # the server decodes ON DEVICE — tones stay distinguishable, the
        # correctness accounting below is unchanged
        from tiresias_tpu.utils.g711 import encode

        i16 = encode(i16, wire)
    frame = SR * FRAME_MS // 1000
    expected = f"tone{clip}"

    try:
        with socket.create_connection(("127.0.0.1", port), timeout=30.0) as s:
            f = s.makefile("rw", encoding="utf-8", newline="\n")
            f.write(json.dumps({
                "op": "open", "channel": f"c{channel}", "context": "m",
                "duration_ms": duration_ms, "continuous": True,
                "hop_ms": hop_ms, "format": wire,
            }) + "\n")
            f.flush()
            assert json.loads(f.readline()).get("opened")

            done = time.monotonic() + seconds
            results: list[dict] = []

            def reader():
                try:
                    for line in f:
                        msg = json.loads(line)
                        if "result" in msg:
                            results.append(msg["result"])
                except (OSError, ValueError):
                    pass

            rt = threading.Thread(target=reader, daemon=True)
            rt.start()
            off = 0
            next_t = time.monotonic()
            while time.monotonic() < done:
                chunk = np.take(  # seamless loop over the clip
                    i16, range(off, off + frame), mode="wrap"
                )
                off = (off + frame) % len(i16)
                f.write(json.dumps({
                    "op": "pcm", "channel": f"c{channel}",
                    "pcm": base64.b64encode(chunk.tobytes()).decode(),
                }) + "\n")
                f.flush()
                next_t += FRAME_MS / 1000
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            n_before = len(results)
            f.write(json.dumps({"op": "hangup", "channel": f"c{channel}"}) + "\n")
            f.flush()
            # the hangup ALWAYS answers (flush result or HANGUP ack) —
            # wait for it instead of a fixed nap, or under load the last
            # window of every client would be dropped from the stats
            deadline = time.monotonic() + 10
            while len(results) <= n_before and time.monotonic() < deadline:
                time.sleep(0.05)
            time.sleep(0.5)  # stragglers from still-in-flight passes
        # the final hangup legitimately answers HANGUP when the last window
        # is still partial — that is contract behavior, not a scored window
        results = [r for r in results if r.get("TIRSTATUS") != "HANGUP"]
        correct = sum(
            1 for r in results
            if r.get("TIRSTATUS") == "FOUND" and r.get("TIRFILENAME") == expected
        )
        if stats.get("debug"):
            for r in results:
                if r.get("TIRFILENAME") != expected:
                    print(
                        f"MISS ch{channel} want={expected} got="
                        f"{r.get('TIRSTATUS')}/{r.get('TIRFILENAME')} "
                        f"{r.get('TIRMATCHCOUNT')}/{r.get('TIRFRAMECOUNT')}",
                        file=sys.stderr,
                    )
        with lock:
            stats["windows"] += len(results)
            stats["correct"] += correct
    except Exception as exc:  # noqa: BLE001 - a failed client is an error stat
        with lock:
            stats["errors"] += 1
        print(f"client {channel} failed: {exc}", file=sys.stderr)


def _rss_mb() -> float:
    with open("/proc/self/status") as fh:
        for ln in fh:
            if ln.startswith("VmRSS:"):
                return float(ln.split()[1]) / 1024.0
    return 0.0


def _hbm_mb() -> float:
    try:
        import jax

        stats = jax.local_devices()[0].memory_stats() or {}
        return float(stats.get("bytes_in_use", 0)) / 2**20
    except Exception:  # noqa: BLE001 - backend without memory_stats
        return 0.0


def mem_sampler(
    stop: threading.Event, samples: list, period: float = 10.0
) -> None:
    """Record (t, host RSS MB, device HBM MB) every ``period`` s for the
    soak's memory-trend assertion (flat memory under sustained load +
    live mutation)."""
    t0 = time.monotonic()
    while not stop.is_set():
        samples.append((time.monotonic() - t0, _rss_mb(), _hbm_mb()))
        stop.wait(period)
    samples.append((time.monotonic() - t0, _rss_mb(), _hbm_mb()))


def mutator(
    port: int,
    mut_dir: str,
    seconds: float,
    stats: dict,
    lock: threading.Lock,
    period: float = 20.0,
) -> None:
    """Live admin-plane mutation under load: every ``period`` s, ingest a
    new clip into its own context via per-context sync, then alternately
    remove it (file + admin remove_audio), with periodic save/compact —
    the store's device views churn (new gens, re-armed prefilter gates)
    while the client fleet keeps recognizing on the untouched context."""
    import os

    from tiresias_tpu.utils.audio import write_wav

    n = ok = fail = 0
    fail_reasons: list = []
    deadline = time.monotonic() + seconds
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=30.0) as s:
            f = s.makefile("rw", encoding="utf-8", newline="\n")

            def admin(**msg):
                f.write(json.dumps({"op": "admin", **msg}) + "\n")
                f.flush()
                return json.loads(f.readline())

            while time.monotonic() < deadline:
                path = os.path.join(mut_dir, f"m{n}.wav")
                # per-cycle unique CONTENT, not just a tone palette: only
                # even cycles are ever removed, so odd clips persist with
                # their hashes — a palette that wraps (31 * (n % 40))
                # reproduces an old hash, sync dedupes it (created=0) and
                # a long soak reports spurious mutator failures
                tone = synth_tone(2400 + 31 * (n % 40), 2.0, SR)
                tone += 1e-4 * np.random.default_rng(n).standard_normal(
                    len(tone)
                ).astype(np.float32)
                write_wav(path, tone, SR)
                r = admin(cmd="sync", context="mut")
                created = r.get("admin", {}).get("sync", {}).get("created")
                ok += created == 1
                if created != 1:
                    fail += 1
                    fail_reasons.append(f"cycle {n} sync: {r}")
                if n % 2:  # remove the previous cycle's clip, live
                    rows = admin(cmd="show_audios", context="mut")
                    rows = rows.get("admin", {}).get("audios", [])
                    victim = next(
                        (r for r in rows
                         if f"m{n - 1}.wav" in str(r.get("name", ""))
                         or str(r.get("name", "")) == f"m{n - 1}"),
                        None,
                    )
                    if victim:
                        os.unlink(
                            os.path.join(mut_dir, f"m{n - 1}.wav")
                        )
                        rm = admin(cmd="remove_audio",
                                   uuid=victim["uuid"])
                        removed = rm.get("admin", {}).get("removed")
                        ok += removed is True
                        if removed is not True:
                            fail += 1
                            fail_reasons.append(f"cycle {n} remove: {rm}")
                if n % 3 == 2:
                    r = admin(cmd="save")
                    good = r.get("admin", {}).get("saved") is True
                    ok += good
                    if not good:
                        fail += 1
                        fail_reasons.append(f"cycle {n} save: {r}")
                if n % 5 == 4:
                    r = admin(cmd="compact")
                    good = r.get("admin", {}).get("compacted") is True
                    ok += good
                    if not good:
                        fail += 1
                        fail_reasons.append(f"cycle {n} compact: {r}")
                n += 1
                wake = time.monotonic() + period
                while time.monotonic() < min(wake, deadline):
                    time.sleep(0.5)
        print(
            f"mutator: {n} cycles, {ok} admin mutations ok, {fail} failed "
            "(live sync/remove/save/compact under full client load)",
            file=sys.stderr,
        )
        for reason in fail_reasons[:5]:
            print(f"mutator fail: {reason}", file=sys.stderr)
        with lock:
            stats["mutations"] = ok
            stats["errors"] += fail
    except Exception as exc:  # noqa: BLE001 - a dead mutator is an error stat
        with lock:
            stats["errors"] += 1
        print(f"mutator failed: {exc}", file=sys.stderr)


def hostile_client(port: int, stats: dict, lock: threading.Lock) -> None:
    """Abusive client exercising every protocol bound: over-cap duration,
    buffer-overflow pushes, unknown-channel hangups, and an over-limit line.
    Success = the server answers clean per-request errors (or drops the
    connection for the unresyncable over-limit line) and keeps serving
    everyone else."""
    from tiresias_tpu.serve.server import MAX_LINE_BYTES

    ok = 0
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=30.0) as s:
            f = s.makefile("rw", encoding="utf-8", newline="\n")
            f.write(json.dumps({"op": "open", "channel": "h", "context": "m",
                                "duration_ms": 86_400_000}) + "\n")
            f.flush()
            ok += "error" in json.loads(f.readline())
            f.write(json.dumps({"op": "hangup", "channel": "ghost"}) + "\n")
            f.flush()
            ok += "error" in json.loads(f.readline())
            f.write(json.dumps({"op": "open", "channel": "h", "context": "m",
                                "duration_ms": 1000}) + "\n")
            f.flush()
            ok += json.loads(f.readline()).get("opened", False)
            giant = base64.b64encode(
                np.zeros(60 * SR, dtype="<i2").tobytes()
            ).decode()
            f.write(json.dumps({"op": "pcm", "channel": "h",
                                "pcm": giant}) + "\n")
            f.flush()
            ok += "overflow" in json.loads(f.readline()).get("error", "")
        with socket.create_connection(("127.0.0.1", port), timeout=30.0) as s:
            f = s.makefile("rw", encoding="utf-8", newline="\n")
            f.write('{"op": "pcm", "channel": "h", "pcm": "')
            f.write("A" * (MAX_LINE_BYTES + 1024))
            f.write('"}\n')
            f.flush()
            ok += json.loads(f.readline()) == {"error": "line too long"}
            ok += f.readline() == ""  # server dropped the connection
        if ok != 6:
            raise RuntimeError(f"hostile client: only {ok}/6 bounds held")
        print("hostile client: all 6 protocol bounds held", file=sys.stderr)
    except Exception as exc:  # noqa: BLE001
        with lock:
            stats["errors"] += 1
        print(f"hostile client failed: {exc}", file=sys.stderr)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--duration-ms", type=int, default=3000)
    ap.add_argument("--hop-ms", type=int, default=1500)
    ap.add_argument(
        "--wire", default="l16", choices=("l16", "ulaw", "alaw"),
        help="wire format every client speaks (G.711 trunk bytes halve "
        "the base64 payload and H2D; decoded on device)",
    )
    ap.add_argument(
        "--hostile", action="store_true",
        help="run an abusive client alongside the fleet; it must get clean "
        "errors while everyone else keeps recognizing",
    )
    ap.add_argument(
        "--mutate", action="store_true",
        help="run a live admin mutator alongside the fleet: per-context "
        "sync ingest, remove, save, compact against the serving store",
    )
    ap.add_argument("--mutate-period", type=float, default=20.0)
    ap.add_argument("--debug", action="store_true")
    ap.add_argument(
        "--cpu", action="store_true",
        help="force the CPU backend",
    )
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from tiresias_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    eng = build_engine(args.wire)
    mut_dir = None
    if args.mutate:
        mut_dir = tempfile.mkdtemp(prefix="tir_soak_mut")
        eng.create_context("mut", mut_dir)
    for b in warmup_batch_sizes(args.channels):
        # warm the ACTUAL window shape: a non-default --duration-ms in a
        # different frame bucket would otherwise compile every batch
        # shape mid-soak, stalling the measured run
        eng.warmup(
            samplerate=SR, batch_sizes=(b,), duration_ms=args.duration_ms,
            laws=() if args.wire == "l16" else (args.wire,),
        )

    holder: dict = {}
    started = threading.Event()

    def runner():
        async def amain():
            # fleet + hostile client both need slots: the default cap
            # (128) would make --hostile at 128 channels fail spuriously
            srv = RecognitionServer(
                eng, port=0, samplerate=SR,
                max_channels=args.channels + 8,
            )
            await srv.start()
            holder["server"] = srv
            holder["loop"] = asyncio.get_running_loop()
            started.set()
            try:
                await srv.serve_forever()
            except asyncio.CancelledError:
                pass

        asyncio.run(amain())

    threading.Thread(target=runner, daemon=True).start()
    assert started.wait(30)
    port = holder["server"].port

    stats = {"windows": 0, "correct": 0, "errors": 0, "debug": args.debug}
    lock = threading.Lock()
    t0 = time.monotonic()
    threads = [
        threading.Thread(
            target=client,
            args=(port, i, i % N_CLIPS, args.seconds, args.duration_ms,
                  args.hop_ms, stats, lock, args.wire),
            daemon=True,
        )
        for i in range(args.channels)
    ]
    if args.hostile:
        threads.append(
            threading.Thread(
                target=hostile_client, args=(port, stats, lock), daemon=True
            )
        )
    if args.mutate:
        threads.append(
            threading.Thread(
                target=mutator,
                args=(port, mut_dir, args.seconds, stats, lock,
                      args.mutate_period),
                daemon=True,
            )
        )
    mem_stop = threading.Event()
    mem_samples: list = []
    mem_thread = threading.Thread(
        target=mem_sampler,
        args=(mem_stop, mem_samples,
              max(1.0, min(10.0, args.seconds / 8))),
        daemon=True,
    )
    mem_thread.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.monotonic() - t0
    mem_stop.set()
    mem_thread.join(timeout=5)
    pct = 100.0 * stats["correct"] / max(1, stats["windows"])
    print(
        f"soak: {stats['windows']} windows, {pct:.1f}% correct, "
        f"{stats['windows'] / elapsed:.1f}/s sustained, "
        f"{stats['errors']} errors "
        f"({args.channels} channels x {args.seconds:.0f}s, "
        f"{args.duration_ms} ms window / {args.hop_ms} ms hop"
        + (f", {stats.get('mutations', 0)} live mutations" if args.mutate
           else "")
        + ")",
        flush=True,
    )
    # memory-trend assertion: compare steady-state halves (the first
    # samples include compile/warm allocations and are excluded)
    mem_flat = True
    if len(mem_samples) < 4:
        print(
            f"soak-mem: only {len(mem_samples)} samples (run too short "
            "for a trend) — flat by default",
            flush=True,
        )
    else:
        body = mem_samples[1:]
        half = len(body) // 2
        rss_a = float(np.median([s[1] for s in body[:half]]))
        rss_b = float(np.median([s[1] for s in body[half:]]))
        hbm_a = float(np.median([s[2] for s in body[:half]]))
        hbm_b = float(np.median([s[2] for s in body[half:]]))
        rss_flat = rss_b <= rss_a * 1.15 + 64
        hbm_flat = hbm_b <= hbm_a * 1.15 + 64
        mem_flat = rss_flat and hbm_flat
        verdict = "flat" if mem_flat else "GROWING"
        print(
            f"soak-mem: RSS median {rss_a:.0f} -> {rss_b:.0f} MB, "
            f"HBM {hbm_a:.0f} -> {hbm_b:.0f} MB over "
            f"{mem_samples[-1][0]:.0f}s ({len(mem_samples)} samples) — "
            f"{verdict}",
            flush=True,
        )
    # stop AFTER reporting; waiting also keeps the interpreter from tearing
    # down the executor under the daemon threads ("cannot schedule new
    # futures after interpreter shutdown"). server.close() cancels
    # serve_forever, which ends the loop's asyncio.run and may cancel the
    # stop() task itself mid-await — a clean shutdown, not a failure.
    try:
        asyncio.run_coroutine_threadsafe(
            holder["server"].stop(), holder["loop"]
        ).result(timeout=30)
    except (TimeoutError, asyncio.CancelledError):
        pass
    return 0 if stats["errors"] == 0 and pct > 95.0 and mem_flat else 1


if __name__ == "__main__":
    main_rc = main()
    sys.exit(main_rc)
