"""Desktop GUI: press an HMM and scan pasted sequences locally.

Parity: gui/deciphon_gui (customtkinter app driving worker press +
launch_scanner, app.py:8,82,131) rebuilt on plain tkinter: pick a .hmm,
press it with a progress bar, paste FASTA or raw sequences, scan, and
read the alignment view.  The controller is separated from the widgets so
the press/scan flow is testable without a display.
"""

from __future__ import annotations

import os
import tempfile
import threading

__all__ = ["GuiController", "run_app"]


class GuiController:
    """Display-free core of the GUI: owns press/scan state."""

    def __init__(self, workdir: str | None = None, engine: str | None = None):
        self.workdir = workdir or tempfile.mkdtemp(prefix="deciphon_gui_")
        self.engine = engine
        self.dcp_path: str | None = None
        self.daemon = None

    def press(self, hmm_path: str, gencode: int = 1, epsilon: float = 0.01,
              progress=None) -> str:
        from .worker import press

        dcp = os.path.join(self.workdir,
                           os.path.basename(hmm_path)[:-4] + ".dcp")
        prog = press(hmm_path, dcp, gencode, epsilon)
        for value in prog.as_progress():
            if progress:
                progress(value)
        self.dcp_path = prog.result()
        return self.dcp_path

    def start_scanner(self, multi_hits=True, hmmer3_compat=False):
        from .worker import launch_scanner

        assert self.dcp_path, "press an HMM first"
        self.daemon = launch_scanner(self.dcp_path, multi_hits,
                                     hmmer3_compat, engine=self.engine)

    def scan_text(self, text: str, progress=None) -> str:
        """Scan pasted sequences; returns the rendered alignment view."""
        from .scan.fasta_io import read_fasta
        from .scan.sequence import Sequence
        from .snap.snap_file import read_snap
        from .snap.view import view_alignments
        import io

        if self.daemon is None:
            self.start_scanner()
        text = text.strip()
        if text.startswith(">"):
            items = list(read_fasta(io.StringIO(text)))
        else:
            items = [(f"seq{i + 1}", line.strip())
                     for i, line in enumerate(text.splitlines())
                     if line.strip()]
        seqs = [Sequence.make(i + 1, name, data)
                for i, (name, data) in enumerate(items)]
        snap_path = os.path.join(self.workdir, "gui_result.dcs")
        if os.path.exists(snap_path):
            os.unlink(snap_path)
        prog = self.daemon.put(snap_path, seqs)
        for value in prog.as_progress():
            if progress:
                progress(value)
        prog.result()
        products = read_snap(snap_path).products
        if not len(products):
            return "(no hits)"
        return view_alignments(products)

    def close(self):
        if self.daemon is not None:
            self.daemon.close()
            self.daemon = None


def run_app():  # pragma: no cover - needs a display
    import tkinter as tk
    from tkinter import filedialog, ttk

    ctl = GuiController()
    root = tk.Tk()
    root.title("Deciphon")
    root.geometry("900x700")

    top = ttk.Frame(root, padding=8)
    top.pack(fill="x")
    status = tk.StringVar(value="choose a .hmm profile file")
    bar = ttk.Progressbar(top, maximum=100)

    def on_press():
        path = filedialog.askopenfilename(
            filetypes=[("HMMER3 profiles", "*.hmm")])
        if not path:
            return
        status.set(f"pressing {os.path.basename(path)}…")

        def work():
            ctl.press(path, progress=lambda v: bar.configure(value=v))
            ctl.start_scanner()
            status.set(f"ready: {os.path.basename(path)} pressed")

        threading.Thread(target=work, daemon=True).start()

    ttk.Button(top, text="Open .hmm…", command=on_press).pack(side="left")
    ttk.Label(top, textvariable=status).pack(side="left", padx=8)
    bar.pack(side="right", fill="x", expand=True, padx=8)

    seq_box = tk.Text(root, height=10)
    seq_box.pack(fill="both", expand=False, padx=8, pady=4)
    seq_box.insert("1.0", "> paste FASTA or raw sequences here\n")

    out_box = tk.Text(root, height=24, font=("Courier", 10))
    out_box.pack(fill="both", expand=True, padx=8, pady=4)

    def on_scan():
        text = seq_box.get("1.0", "end")
        status.set("scanning…")

        def work():
            try:
                view = ctl.scan_text(
                    text, progress=lambda v: bar.configure(value=v))
            except Exception as exc:
                view = f"error: {exc}"
            out_box.delete("1.0", "end")
            out_box.insert("1.0", view)
            status.set("done")

        threading.Thread(target=work, daemon=True).start()

    ttk.Button(root, text="Scan", command=on_scan).pack(pady=4)
    root.protocol("WM_DELETE_WINDOW",
                  lambda: (ctl.close(), root.destroy()))
    root.mainloop()


if __name__ == "__main__":  # pragma: no cover
    run_app()
