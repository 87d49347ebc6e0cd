#!/usr/bin/env python3
"""EAGI bridge: the reference's ``Tiresias()`` dialplan application, over AGI.

The reference is an in-process Asterisk module
(/root/reference/src/application_handler.c): the dialplan calls
``Tiresias(context,duration,tolerance,low,high)``, the module records the
channel, searches, and sets seven ``TIR*`` channel variables. This script
reproduces that contract for this framework without any Asterisk C code:
Asterisk invokes it as an **EAGI** script (raw 8 kHz signed-linear channel
audio on fd 3), it streams the audio to a running ``tiresias serve`` TCP
service, and sets the same TIR* variables back on the channel.

Dialplan (same arguments as the reference,
/root/reference/doc/dialplan_application.rst):

    exten => 100,1,Answer()
    ; context, duration_ms, tolerance, freq_ignore_low, freq_ignore_high
    same  => n,EAGI(agi_tiresias.py,media,3000,0.01)
    same  => n,GotoIf($["${TIRSTATUS}" = "FOUND"]?found:notfound)

Stdlib-only; point it at the service with TIRESIAS_HOST / TIRESIAS_PORT.
"""

import base64
import json
import os
import socket
import sys

EAGI_AUDIO_FD = 3
SAMPLERATE = 8000
BYTES_PER_SAMPLE = 2  # slin: int16 LE mono


def agi_read_env(stdin) -> dict:
    env = {}
    for line in stdin:
        line = line.strip()
        if not line:
            break
        key, _, value = line.partition(":")
        env[key.strip()] = value.strip()
    return env


def agi_command(stdout, stdin, cmd: str) -> str:
    stdout.write(cmd + "\n")
    stdout.flush()
    return stdin.readline().strip()


def agi_set_variable(stdout, stdin, name: str, value: str) -> None:
    agi_command(stdout, stdin, f'SET VARIABLE {name} "{value}"')


def read_channel_audio(duration_ms: int) -> bytes:
    """Read duration_ms of raw slin audio from the EAGI audio descriptor.

    A short read means hangup — mirrored as TIRSTATUS=HANGUP like the
    reference's record loop (application_handler.c:165-170)."""
    want = SAMPLERATE * BYTES_PER_SAMPLE * duration_ms // 1000
    chunks, got = [], 0
    while got < want:
        chunk = os.read(EAGI_AUDIO_FD, min(65536, want - got))
        if not chunk:
            break
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recognize(host: str, port: int, context: str, pcm: bytes,
              duration_ms: int, tolerance: float | None,
              freq_lo: int, freq_hi: int) -> dict:
    """One open → pcm → result round trip against tiresias serve."""
    with socket.create_connection((host, port), timeout=30) as sock:
        f = sock.makefile("rw", encoding="utf-8", newline="\n")
        open_msg = {
            "op": "open", "channel": "agi", "context": context,
            "duration_ms": duration_ms,
            "freq_ignore_low": freq_lo, "freq_ignore_high": freq_hi,
        }
        if tolerance is not None:
            open_msg["tolerance"] = tolerance
        f.write(json.dumps(open_msg) + "\n")
        f.write(json.dumps({
            "op": "pcm", "channel": "agi",
            "pcm": base64.b64encode(pcm).decode(),
        }) + "\n")
        f.flush()
        for line in f:
            msg = json.loads(line)
            if msg.get("error"):
                raise RuntimeError(msg["error"])
            if "result" in msg:
                return msg["result"]
    raise RuntimeError("server closed without a result")


def main() -> int:
    stdin, stdout = sys.stdin, sys.stdout
    agi_read_env(stdin)
    # args exactly as the reference parses them (application_handler.c:81-137)
    args = sys.argv[1:]
    context = args[0] if args else ""
    duration_ms = int(args[1]) if len(args) > 1 and args[1] else 3000
    tolerance = float(args[2]) if len(args) > 2 and args[2] else None
    freq_lo = int(args[3]) if len(args) > 3 and args[3] else -1
    freq_hi = int(args[4]) if len(args) > 4 and args[4] else -1

    pcm = read_channel_audio(duration_ms)
    if len(pcm) < SAMPLERATE * BYTES_PER_SAMPLE * duration_ms // 1000:
        agi_set_variable(stdout, stdin, "TIRSTATUS", "HANGUP")
        return 0

    host = os.environ.get("TIRESIAS_HOST", "127.0.0.1")
    port = int(os.environ.get("TIRESIAS_PORT", "8517"))
    try:
        result = recognize(host, port, context, pcm, duration_ms,
                           tolerance, freq_lo, freq_hi)
    except Exception as exc:  # degrade like the reference's failure path
        sys.stderr.write(f"tiresias AGI: {exc}\n")
        agi_set_variable(stdout, stdin, "TIRSTATUS", "NOTFOUND")
        return 0
    for key, value in result.items():
        agi_set_variable(stdout, stdin, key, str(value))
    return 0


if __name__ == "__main__":
    sys.exit(main())
