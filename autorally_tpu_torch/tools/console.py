"""Operator console — the OCS role as a terminal dashboard (the port's copy
of ``autorally_tpu/tools/console.py``).

The reference's Operator Control Station (``autorally_core/src/ocs/``:
Qt GUI, ``main_window.cpp`` + ``qnode.cpp``) subscribes to diagnostics,
chassis state, runstop and image topics and shows per-node health with
staleness coloring, plus a runstop toggle.  This console is that role
over the framework's telemetry feed (:mod:`runtime.telemetry_bus`): it
listens for JSON datagrams from a live run, renders a refreshing ANSI
dashboard — run header, solver state (speed / ESS / crash% / chosen
controller), timing percentiles vs budget, lap table, per-component
diagnostics with stale detection (``DiagnosticsEntry.cpp:94-143`` role),
host/accelerator status — and can toggle the run's motion-enable with the
``r`` key (the OCS runstop checkbox, ``main_window.cpp`` runstop
publisher).  ``--log`` also appends every received record to a JSONL
file, making the console a run recorder.

Attach to a live run::

    python -m autorally_tpu_torch.run_tube_mppi --telemetry-port 48100 &
    python -m autorally_tpu_torch.tools.console --port 48100

Non-interactive snapshots: ``--once`` or ``--duration N`` (no tty
required; used by the tests).
"""

from __future__ import annotations

import argparse
import json
import select
import socket
import sys
import time
from typing import Optional

RESET = "\x1b[0m"
BOLD = "\x1b[1m"
DIM = "\x1b[2m"
_COLORS = {"ok": "\x1b[32m", "warn": "\x1b[33m", "error": "\x1b[31m",
           "stale": "\x1b[90m"}


def _c(level: str, text: str, color: bool = True) -> str:
    if not color:
        return text
    return _COLORS.get(level, "") + text + RESET


class ConsoleState:
    """Latest-record store with staleness tracking per telemetry kind."""

    def __init__(self, stale_s: float = 3.0):
        self.stale_s = stale_s
        self.latest: dict = {}                # kind -> (recv_time, record)
        self.laps: list = []
        self.records = 0
        self.motion_enabled = True

    def ingest(self, rec: dict, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        kind = rec.get("kind", "?")
        self.latest[kind] = (now, rec)
        self.records += 1
        if kind == "lap":
            self.laps.append(rec)

    def _get(self, kind: str, now: float):
        """(record, is_stale) or (None, True)."""
        if kind not in self.latest:
            return None, True
        t, rec = self.latest[kind]
        return rec, (now - t) > self.stale_s

    def render(self, now: Optional[float] = None, color: bool = True,
               width: int = 78) -> str:
        now = time.time() if now is None else now
        L = []
        bar = "=" * width

        run, run_stale = self._get("run", now)
        title = "autorally_tpu operator console"
        if run:
            title += (f"  |  K={run.get('num_rollouts','?')} "
                      f"T={run.get('num_timesteps','?')} "
                      f"{run.get('hz','?')} Hz  plant={run.get('plant','?')}")
        L.append((BOLD if color else "") + title + (RESET if color else ""))
        L.append(bar)

        motion = ("MOTION ENABLED" if self.motion_enabled
                  else "RUNSTOP ENGAGED")
        L.append(_c("ok" if self.motion_enabled else "error", motion, color)
                 + f"   records={self.records}")

        solve, st = self._get("solve", now)
        if solve:
            lvl = "stale" if st else ("warn" if solve.get("crash_pct", 0) > 10
                                      else "ok")
            L.append(_c(lvl,
                        f"tick {solve.get('tick','?'):>6}  "
                        f"pos=({solve.get('x',0):+7.2f},{solve.get('y',0):+7.2f})  "
                        f"speed={solve.get('speed',0):5.2f} m/s  "
                        f"using={solve.get('used','?'):<9}  "
                        f"ess={solve.get('ess',0):7.1f}  "
                        + (f"gamma={solve['gamma']:.3f}  "
                           if "gamma" in solve else "")
                        + f"crash={solve.get('crash_pct',0):4.1f}%  "
                        f"cost={solve.get('traj_cost',0):8.3g}"
                        + ("  [STALE]" if st else ""), color))
        else:
            L.append(_c("stale", "solver: no data", color))

        timing, st = self._get("timing", now)
        if timing:
            over = timing.get("tickP99Ms", 0) > timing.get("budget_ms", 1e9)
            lvl = "stale" if st else ("warn" if over or
                                      timing.get("missedTicks", 0) else "ok")
            L.append(_c(lvl,
                        f"timing: tick avg {timing.get('avg_tick_ms',0):6.2f} ms"
                        f"  p50 {timing.get('tickP50Ms',0):6.2f}"
                        f"  p99 {timing.get('tickP99Ms',0):6.2f}"
                        f"  budget {timing.get('budget_ms',0):.0f} ms"
                        f"  missed {timing.get('missedTicks',0)}", color))

        if self.laps:
            L.append(BOLD + "laps:" + RESET if color else "laps:")
            for lap in self.laps[-5:]:
                L.append(f"  lap {lap.get('lap_number','?'):>2}: "
                         f"{lap.get('lap_time',0):6.2f} s   "
                         f"max_speed {lap.get('max_speed',0):5.2f} m/s   "
                         f"max_slip {lap.get('max_slip',0):5.3f} rad")

        diag, st = self._get("diag", now)
        L.append(bar)
        if diag and "components" in diag:
            lvl = "stale" if st else diag.get("level", "ok")
            L.append(_c(lvl, f"diagnostics [{diag.get('level','?')}]"
                       + ("  [STALE]" if st else ""), color))
            for name, comp in sorted(diag["components"].items()):
                clvl = "stale" if st else comp.get("level", "ok")
                entries = comp.get("entries", {})
                msg = "; ".join(f"{k}: {e.get('message','')}"
                                for k, e in sorted(entries.items()))
                L.append("  " + _c(clvl, f"{name:<12} [{comp.get('level','?'):<5}] "
                                   + msg[: width - 24], color))
        else:
            L.append(_c("stale", "diagnostics: no data", color))

        system, st = self._get("system", now)
        if system:
            mem = system.get("memory") or {}
            disk = system.get("disk") or {}
            acc = system.get("accelerator") or {}
            ts = system.get("time_sync") or {}
            sync = ("sync" if ts.get("synchronized")
                    else ("UNSYNC" if ts.get("available") else "n/a"))
            L.append(_c("stale" if st else "ok",
                        f"host: cpu {system.get('cpu_pct','?')}%  "
                        f"mem {mem.get('used_pct','?')}%  "
                        f"disk {disk.get('used_pct','?')}%  "
                        f"clock {sync}  "
                        f"accel {acc.get('device_count',0)}x"
                        f"{acc.get('platform','?')}", color))

        image, st = self._get("image", now)
        if image and image.get("ascii"):
            # the OCS image view, terminal edition: ASCII luminance
            # frames from the ImageRepublisher (vision/scene_camera.py)
            hdr = (f"camera  msv={image.get('msv', 0):5.1f}  "
                   f"shutter={image.get('shutter', 0):7.1f}  "
                   f"gain={image.get('gain', 0):5.2f}"
                   + ("  [STALE]" if st else ""))
            L.append(_c("stale" if st else "ok", hdr, color))
            dimc = DIM if color else ""
            rst = RESET if color else ""
            for row in image["ascii"][:16]:
                L.append(dimc + "  |" + str(row)[: width - 6] + "|" + rst)

        L.append(DIM + "[r] toggle runstop   [q] quit" + RESET
                 if color else "[r] toggle runstop   [q] quit")
        return "\n".join(L)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=48100,
                    help="UDP port to listen for telemetry on")
    ap.add_argument("--runstop-port", type=int, default=None,
                    help="run's runstop port for the [r] toggle")
    ap.add_argument("--runstop-host", default="127.0.0.1")
    ap.add_argument("--log", default=None,
                    help="append every received record to this JSONL file")
    ap.add_argument("--refresh", type=float, default=0.2)
    ap.add_argument("--duration", type=float, default=None,
                    help="exit after N seconds (non-interactive mode)")
    ap.add_argument("--wait-data", type=float, default=None,
                    help="with --duration: start the countdown at the "
                         "first received frame, waiting up to this many "
                         "seconds for it (absorbs the publisher's start-up "
                         "and kernel builds on a loaded host)")
    ap.add_argument("--once", action="store_true",
                    help="collect briefly, print one frame, exit")
    ap.add_argument("--no-color", action="store_true")
    args = ap.parse_args(argv)

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", args.port))
    sock.setblocking(False)
    state = ConsoleState()
    log = open(args.log, "a") if args.log else None
    color = not args.no_color and sys.stdout.isatty()
    interactive = sys.stdin.isatty() and not (args.once or args.duration)

    old_termios = None
    if interactive:
        try:
            import termios
            import tty

            old_termios = termios.tcgetattr(sys.stdin.fileno())
            tty.setcbreak(sys.stdin.fileno())
        except Exception:
            interactive = False

    waiting = bool(args.wait_data and args.duration)
    t_end = time.time() + (args.wait_data if waiting
                           else args.duration if args.duration
                           else (1.0 if args.once else 1e18))
    try:
        last_draw = 0.0
        while time.time() < t_end:
            rlist = [sock] + ([sys.stdin] if interactive else [])
            ready, _, _ = select.select(rlist, [], [], args.refresh)
            for r in ready:
                if r is sock:
                    try:
                        while True:
                            data, _ = sock.recvfrom(65536)
                            try:
                                rec = json.loads(data.decode())
                            except ValueError:
                                continue
                            state.ingest(rec)
                            if waiting:
                                waiting = False
                                t_end = time.time() + args.duration
                            if log:
                                log.write(data.decode() + "\n")
                    except BlockingIOError:
                        pass
                elif interactive and r is sys.stdin:
                    ch = sys.stdin.read(1)
                    if ch == "q":
                        t_end = 0
                    elif ch == "r" and args.runstop_port:
                        from autorally_tpu_torch.runtime.telemetry_bus \
                            import send_runstop

                        state.motion_enabled = not state.motion_enabled
                        send_runstop(args.runstop_port, "ocs_console",
                                     state.motion_enabled,
                                     host=args.runstop_host)
            now = time.time()
            if not args.once and now - last_draw >= args.refresh:
                frame = state.render(now, color=color)
                if sys.stdout.isatty():
                    sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
                else:
                    sys.stdout.write(frame + "\n" + "-" * 78 + "\n")
                sys.stdout.flush()
                last_draw = now
        if args.once:
            print(state.render(color=color))
    finally:
        if old_termios is not None:
            import termios

            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN,
                              old_termios)
        if log:
            log.close()
        sock.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
