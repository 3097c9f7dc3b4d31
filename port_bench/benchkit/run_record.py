"""What a run hands to the metric readers and to the result line."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .trace import DeviceTrace


@dataclass
class Check:
    """One number compared for ``correct``, beside its limit: it passes
    where ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class RunRecord:
    kind: str  # "serve" or "train"
    model: Dict
    setup_s: float = 0.0
    window_s: float = 0.0
    # serving: (frames, windows forwarded, seconds from upload to CSV) per clip
    clips: List[Tuple[int, int, float]] = field(default_factory=list)
    # training: steps completed in the window, and the batch size
    steps: int = 0
    batch: int = 0
    spans: Dict[str, float] = field(default_factory=dict)
    trace: Optional[DeviceTrace] = None
    # what ran inside the profiled sub-window: frames, windows and clips, or
    # steps; and its host seconds (host_s)
    traced: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    checks: List[Check] = field(default_factory=list)
    notes: Dict[str, object] = field(default_factory=dict)

    @property
    def frames(self) -> int:
        return sum(c[0] for c in self.clips)

    @property
    def windows(self) -> int:
        return sum(c[1] for c in self.clips)

    # the window without its profiled sub-window, which the profiler slows
    @property
    def untraced_s(self) -> float:
        return self.window_s - self.traced.get("host_s", 0.0)

    @property
    def untraced_frames(self) -> int:
        return self.frames - int(self.traced.get("frames", 0))

    @property
    def untraced_windows(self) -> int:
        return self.windows - int(self.traced.get("windows", 0))

    @property
    def untraced_steps(self) -> int:
        return self.steps - int(self.traced.get("steps", 0))
