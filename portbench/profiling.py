"""What a torch.profiler trace of a stretch of the window says: the
device's busy time, its heaviest operations, and its idle gaps named by the
benchmark's own spans around its calls into the program.

The harness wraps every call it makes in the traced stretch in
``torch.profiler.record_function("portbench.<span>")`` and the whole
stretch in ``portbench.stretch``; device time is the union of the device
activities (kernels, copies, sets) inside the stretch.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PREFIX = "portbench."
STRETCH = PREFIX + "stretch"
BETWEEN = "between_calls"  # host time outside every span of the harness
TOP = 10


def profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(prof) -> Dict:
    """{busy_s, window_s, device_ops, idle_gaps} of a finished trace
    (seconds; the lists as [name, seconds], the largest first)."""
    from torch.autograd import DeviceType

    spans, device, by_op = [], [], {}
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if name.startswith(PREFIX):
            if e.device_type() != DeviceType.CPU:
                continue  # the same annotation on the device's timeline
            if name == STRETCH:
                window = (a, b)
            else:
                spans.append((a, b, name[len(PREFIX):]))
        elif e.device_type() == DeviceType.CUDA:
            device.append((a, b))
            key = name[:80]
            by_op[key] = by_op.get(key, 0) + (b - a)
    if window is None:
        raise RuntimeError("the trace holds no portbench.stretch span")
    w0, w1 = window
    busy = _union([(max(a, w0), min(b, w1)) for a, b in device if b > w0 and a < w1])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    idle: Dict[str, int] = {}
    spans.sort()
    i = 0
    for g0, g1 in gaps:
        covered = 0
        while i < len(spans) and spans[i][1] <= g0:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < g1:
            o = min(g1, spans[j][1]) - max(g0, spans[j][0])
            if o > 0:
                idle[spans[j][2]] = idle.get(spans[j][2], 0) + o
                covered += o
            j += 1
        if g1 - g0 > covered:
            idle[BETWEEN] = idle.get(BETWEEN, 0) + (g1 - g0 - covered)

    def top(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": sum(b - a for a, b in busy) / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_ops": top(by_op), "idle_gaps": top(idle),
            "device_events": len(device)}
