"""Live plotting (counterpart of ``deepflows_tpu/utils/visual.py``).
matplotlib is optional; the Animator degrades to metric recording when it is
unavailable or headless."""

from __future__ import annotations


def use_svg_display():
    try:
        from matplotlib_inline import backend_inline

        backend_inline.set_matplotlib_formats("svg")
    except ImportError:
        pass


class Animator:
    """Incremental line plotting for training curves; always records the
    series in ``self.X``/``self.Y`` so headless runs keep the data."""

    def __init__(
        self,
        xlabel=None,
        ylabel=None,
        legend=None,
        xlim=None,
        ylim=None,
        xscale="linear",
        yscale="linear",
        fmts=("-", "m--", "g-.", "r:"),
        nrows=1,
        ncols=1,
        figsize=(3.5, 2.5),
    ):
        self.legend = legend or []
        self.fmts = fmts
        self.X, self.Y = None, None
        self._cfg = dict(
            xlabel=xlabel, ylabel=ylabel, xlim=xlim, ylim=ylim,
            xscale=xscale, yscale=yscale,
        )
        try:
            import matplotlib.pyplot as plt

            self._plt = plt
            self.fig, self.axes = plt.subplots(nrows, ncols, figsize=figsize)
            if nrows * ncols == 1:
                self.axes = [self.axes]
        except Exception:
            self._plt = None
            self.fig, self.axes = None, None

    def add(self, x, y):
        if not hasattr(y, "__len__"):
            y = [y]
        n = len(y)
        if not hasattr(x, "__len__"):
            x = [x] * n
        if self.X is None:
            self.X = [[] for _ in range(n)]
        if self.Y is None:
            self.Y = [[] for _ in range(n)]
        for i, (a, b) in enumerate(zip(x, y)):
            if a is not None and b is not None:
                self.X[i].append(a)
                self.Y[i].append(b)
        if self._plt is None:
            return
        ax = self.axes[0]
        ax.cla()
        for xs, ys, fmt in zip(self.X, self.Y, self.fmts):
            ax.plot(xs, ys, fmt)
        cfg = self._cfg
        if cfg["xlabel"]:
            ax.set_xlabel(cfg["xlabel"])
        if cfg["ylabel"]:
            ax.set_ylabel(cfg["ylabel"])
        ax.set_xscale(cfg["xscale"])
        ax.set_yscale(cfg["yscale"])
        if cfg["xlim"]:
            ax.set_xlim(cfg["xlim"])
        if cfg["ylim"]:
            ax.set_ylim(cfg["ylim"])
        if self.legend:
            ax.legend(self.legend)
        ax.grid()

    def save(self, path):
        if self.fig is not None:
            self.fig.savefig(path, bbox_inches="tight")
