"""Communication op logging with algorithmic/bus bandwidth (a copy of ``deepspeed_tpu/comm/comms_logging.py``).

Parity with reference ``deepspeed/utils/comms_logging.py`` (``CommsLogger:67``,
``calc_bw_log:34``). The facade (``comm.py``) times each eager collective
to its completion (a device synchronise on the card); "bus bandwidth" uses
the collective-algorithm factors (ring allreduce 2(n-1)/n etc.) with n the
ranks of the op's group. A record's name is the op's log name.
"""

import math
from typing import Dict

from ..utils.logging import log_dist, logger


def get_caller_func(frame_depth=3):
    import sys

    frame = sys._getframe(frame_depth)
    return frame.f_code.co_name


def convert_size(size_bytes: int) -> str:
    if size_bytes == 0:
        return "0B"
    size_name = ("B", "KB", "MB", "GB", "TB", "PB")
    i = int(math.floor(math.log(size_bytes, 1024)))
    p = math.pow(1024, i)
    s = round(size_bytes / p, 2)
    return f"{s} {size_name[i]}"


def calc_bw_log(comm_op: str, size_bytes: int, duration_s: float, n: int):
    """Return (msg_size, algbw GB/s, busbw GB/s) for one collective."""
    duration_s = max(duration_s, 1e-9)
    if comm_op in ("all_to_all", "all_to_all_single"):
        tput = size_bytes / duration_s
        busbw = (size_bytes / duration_s) * ((n - 1) / max(n, 1))
    elif comm_op in ("all_gather", "all_gather_into_tensor", "reduce_scatter",
                     "reduce_scatter_tensor"):
        size_bytes = size_bytes * n
        tput = size_bytes / duration_s
        busbw = (size_bytes / duration_s) * ((n - 1) / max(n, 1))
    elif comm_op in ("all_reduce",):
        tput = size_bytes * 2 / duration_s
        busbw = (size_bytes / duration_s) * (2 * (n - 1) / max(n, 1))
    elif comm_op in ("send", "recv", "isend", "irecv", "broadcast", "reduce",
                     "gather", "scatter", "ppermute", "barrier"):
        tput = size_bytes / duration_s
        busbw = tput
    else:
        logger.warning(f"unknown comm op {comm_op} for bw log")
        tput = size_bytes / duration_s
        busbw = tput
    return size_bytes, tput / 1e9, busbw / 1e9


class CommsLogger:
    """Records per-op size/latency/bandwidth records (reference ``CommsLogger``)."""

    def __init__(self, enabled=False, verbose=False, prof_all=True, prof_ops=None, debug=False):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.prof_ops = prof_ops or []
        self.debug = debug
        self.comms_dict: Dict[str, Dict[int, list]] = {}

    def configure(self, comms_config):
        self.enabled = comms_config.enabled
        self.verbose = comms_config.verbose
        self.prof_all = comms_config.prof_all
        self.prof_ops = comms_config.prof_ops
        self.debug = comms_config.debug

    def start_profiling_comms(self):
        self.enabled = True

    def stop_profiling_comms(self):
        self.enabled = False

    def append(self, raw_name: str, record_name: str, latency_s: float, msg_size: int, n: int):
        size, algbw, busbw = calc_bw_log(raw_name, msg_size, latency_s, n)
        rec = self.comms_dict.setdefault(record_name, {})
        if size in rec:
            rec[size][0] += 1
            rec[size][1].append(latency_s)
            rec[size][2].append(algbw)
            rec[size][3].append(busbw)
        else:
            rec[size] = [1, [latency_s], [algbw], [busbw]]
        if self.verbose:
            log_dist(
                f"rank=0 | comm op: {record_name} | time (ms): {latency_s * 1000:.2f} | "
                f"msg size: {convert_size(size)} | algbw (Gbps): {algbw * 8:.2f} | busbw (Gbps): {busbw * 8:.2f}",
                ranks=[0],
            )

    def log_all(self, print_log=True, show_straggler=False):
        from ..utils.timer import trim_mean

        if show_straggler:
            # the reference diffs per-rank minimum latencies across ranks;
            # this logger holds one rank's records
            logger.warning(
                "show_straggler: the per-rank latency breakdown is not gathered; "
                "showing this rank's latencies only"
            )
        if print_log:
            print("Comm. Op\tMessage Size\tCount\tTotal Latency(ms)\tAvg Latency(ms)\ttput_avg (Gbps)\tbusbw_avg (Gbps)")
        results = {}
        for record_name, records in self.comms_dict.items():
            if print_log:
                print(record_name)
            results[record_name] = {}
            for size, vals in sorted(records.items()):
                count, latencies, algbws, busbws = vals
                avg_lat = trim_mean(latencies, 0.1)
                avg_algbw = trim_mean(algbws, 0.1)
                avg_busbw = trim_mean(busbws, 0.1)
                results[record_name][size] = dict(
                    count=count,
                    total_latency_ms=sum(latencies) * 1000,
                    avg_latency_ms=avg_lat * 1000,
                    algbw_gbps=avg_algbw * 8,
                    busbw_gbps=avg_busbw * 8,
                )
                if print_log:
                    print(
                        f"\t\t\t{convert_size(size)}\t{count}\t{sum(latencies) * 1000:.2f}\t"
                        f"{avg_lat * 1000:.2f}\t{avg_algbw * 8:.2f}\t{avg_busbw * 8:.2f}"
                    )
        return results
