"""OS system-audio capture source — the live-input half of C11.

The reference captures whatever the machine is playing via a Windows
WASAPI *loopback* client on a background thread
(``ComponentFramework/AudioReactive.cpp:62-164``).  This rebuild
targets Linux hosts, where the equivalent is reading the PulseAudio /
PipeWire monitor (or an ALSA device) through a PCM-streaming child
process:

    parec      --format=s16le --rate=R --channels=1 [-d <monitor>]
    pw-record  --format s16 --rate R --channels 1 -
    arecord    -q -f S16_LE -r R -c 1 -t raw [-D device]

``SystemCaptureSource`` spawns the first available tool and exposes the
stream through the same ``CaptureSource`` protocol the reactor's
background thread already consumes (``audio/reactive.py``), so live
system audio feeds the exact same DSP as every other source.

The capture *transport* is the subprocess pipe; all parsing, pacing and
envelope logic is in-process and covered by tests that substitute a
fake PCM producer for the real tool (this sandbox has no audio stack —
``/dev/snd`` does not exist — so the real binaries are exercised on
user machines, not in CI).
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Sequence

import numpy as np


def _candidate_commands(sample_rate: int, device: Optional[str]
                        ) -> List[List[str]]:
    cmds: List[List[str]] = []
    parec = ["parec", "--format=s16le", f"--rate={sample_rate}",
             "--channels=1", "--raw"]
    if device:
        parec += ["-d", device]
    cmds.append(parec)
    cmds.append(["pw-record", "--format", "s16", "--rate",
                 str(sample_rate), "--channels", "1", "-"])
    arec = ["arecord", "-q", "-f", "S16_LE", "-r", str(sample_rate),
            "-c", "1", "-t", "raw"]
    if device:
        arec += ["-D", device]
    cmds.append(arec)
    return cmds


class SystemCaptureSource:
    """Mono s16le PCM from an OS capture subprocess.

    ``command``: explicit argv (tests use a fake producer); otherwise
    the first of parec / pw-record / arecord found on PATH.  Raises
    RuntimeError when no capture tool exists — the reactor reports it
    as "Idle, no capture device", mirroring the reference's failed
    WASAPI init path (``AudioReactive.cpp:84-90``).
    """

    def __init__(self, sample_rate: int = 48000,
                 command: Optional[Sequence[str]] = None,
                 device: Optional[str] = None):
        self.sample_rate = int(sample_rate)
        if command is None:
            for cand in _candidate_commands(self.sample_rate, device):
                if shutil.which(cand[0]):
                    command = cand
                    break
            else:
                raise RuntimeError(
                    "no system-audio capture tool found (need parec, "
                    "pw-record or arecord on PATH)")
        self._argv = list(command)
        self._proc = subprocess.Popen(
            self._argv, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, bufsize=0)

    def read_packet(self, max_samples: int) -> Optional[np.ndarray]:
        """Blocking read of up to ``max_samples`` mono samples; None
        once the producer exits (device lost / stream ended)."""
        assert self._proc.stdout is not None
        raw = self._proc.stdout.read(2 * max_samples)
        if not raw:
            return None
        if len(raw) & 1:            # partial trailing sample
            raw = raw[:-1]
        pcm = np.frombuffer(raw, dtype="<i2")
        return pcm.astype(np.float32) / 32768.0

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
