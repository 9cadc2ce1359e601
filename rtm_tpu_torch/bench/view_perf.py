"""Measure.txt post-processing — reference viewPerf.py parity
(RayTracing/viewPerf.py:1-17): read `angle avg_ms` lines, convert to FPS,
print Mean/Max/Min, and plot FPS vs angle when matplotlib is available.
Port of rtm_tpu/bench/view_perf.py; the file format is the same, so either
package reads the other's Measure.txt."""
from __future__ import annotations

import numpy as np


def load(path: str = "Measure.txt") -> np.ndarray:
    rows = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                rows.append((float(parts[0]), float(parts[1])))
    return np.asarray(rows, np.float64)


def main(path: str = "Measure.txt", plot: bool = True,
         save: str | None = None) -> dict:
    from .measure import summarize

    arr = load(path)
    fps = 1000.0 / arr[:, 1]
    stats = summarize(arr)
    print(f"Mean: {stats['mean_fps']}")
    print(f"Max: {stats['max_fps']}")
    print(f"Min: {stats['min_fps']}")
    if plot or save:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            plt.plot(arr[:, 0], fps)
            plt.xlabel("angle [deg]")
            plt.ylabel("FPS")
            if save:
                plt.savefig(save, dpi=120)
            plt.close()
        except ImportError:
            pass
    return stats


if __name__ == "__main__":
    import sys
    main(sys.argv[1] if len(sys.argv) > 1 else "Measure.txt")
