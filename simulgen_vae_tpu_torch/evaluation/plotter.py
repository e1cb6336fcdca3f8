"""Matplotlib plotters (``simulgen_vae_tpu/evaluation/plotter.py``).

matplotlib is imported at first use, never when a module is imported: the
card's machine has none, and training there must not need it. Figures are
saved with the Agg backend; ``SIMULGEN_INTERACTIVE_PLOTS=1`` on a machine
with a display also shows them (``plt.show()``) when ``print_graph != "0"``.
"""

from __future__ import annotations

import os


def _interactive() -> bool:
    return os.environ.get("SIMULGEN_INTERACTIVE_PLOTS") == "1"


def pyplot():
    """``matplotlib.pyplot``, imported now (Agg unless interactive). Raises
    ImportError where matplotlib is not installed."""
    import matplotlib

    if not _interactive():
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def have_matplotlib() -> bool:
    try:
        pyplot()
    except ImportError:
        return False
    return True


def _finish(plt, fig, print_graph, save_path):
    """Shared save/show/close tail for every plotter."""
    if save_path:
        plt.savefig(save_path, dpi=150, bbox_inches="tight")
    if _interactive() and str(print_graph) != "0":
        plt.show()
    plt.close(fig)
    return fig


def temporal_plotter(data, axis, a, c, print_graph, n, save_path=None):
    """Temporal evolution at selected params (axis=0) or nodes (axis=2) of
    ``data`` [param, time, node]."""
    plt = pyplot()
    fig = plt.figure()
    if axis == 0:
        for i in range(n):
            plt.plot(data[a + i, :, c], label=f"param_{a + i}")
    elif axis == 2:
        for i in range(n):
            plt.plot(data[a, :, c + i], label=f"node_{c + i}")
    plt.legend()
    plt.title("Temporal Evolution")
    plt.xlabel("Time Index")
    plt.ylabel("Value")
    plt.grid(True, alpha=0.3)
    return _finish(plt, fig, print_graph, save_path)


def nodal_plotter(data, axis, a, c, print_graph, n, time_idx=None,
                  save_path=None):
    """Nodal (spatial) distribution at selected times/params."""
    plt = pyplot()
    if time_idx is None:
        time_idx = data.shape[1] // 2
    fig = plt.figure(figsize=(12, 6))
    if axis == 0:
        for i in range(n):
            plt.plot(data[a + i, time_idx, :], ".", label=f"param_{a + i}",
                     markersize=1)
    elif axis == 1:
        for i in range(n):
            t_idx = min(time_idx + i * 10, data.shape[1] - 1)
            plt.plot(data[a, t_idx, :], ".", label=f"t_{t_idx}", markersize=1)
    plt.legend()
    plt.title(f"Nodal Distribution (t={time_idx})")
    plt.xlabel("Node Index")
    plt.ylabel("Value")
    plt.grid(True, alpha=0.3)
    return _finish(plt, fig, print_graph, save_path)


def dual_view_plotter(data, param_idx=0, node_indices=None, time_indices=None,
                      print_graph="1", save_path=None):
    """Dual temporal + nodal view of one parameter."""
    plt = pyplot()
    if node_indices is None:
        nn = data.shape[2]
        node_indices = [nn // 4, nn // 2, 3 * nn // 4]
    if time_indices is None:
        nt = data.shape[1]
        time_indices = [nt // 4, nt // 2, 3 * nt // 4]

    fig, axes = plt.subplots(1, 2, figsize=(16, 6))
    fig.suptitle(f"Dual View - Parameter {param_idx}", fontsize=14)
    colors = ["blue", "green", "red"]

    axes[0].set_title("Temporal View - Time Evolution")
    for i, node_idx in enumerate(node_indices):
        axes[0].plot(data[param_idx, :, node_idx], "-", color=colors[i],
                     label=f"node_{node_idx}")
    axes[0].set_xlabel("Time Index")
    axes[0].set_ylabel("Value")
    axes[0].legend()
    axes[0].grid(True, alpha=0.3)

    axes[1].set_title("Nodal View - Spatial Distribution")
    for i, time_idx in enumerate(time_indices):
        axes[1].plot(data[param_idx, time_idx, :], ".", color=colors[i],
                     label=f"t_{time_idx}", markersize=1)
    axes[1].set_xlabel("Node Index")
    axes[1].set_ylabel("Value")
    axes[1].legend()
    axes[1].grid(True, alpha=0.3)

    plt.tight_layout()
    return _finish(plt, fig, print_graph, save_path)
