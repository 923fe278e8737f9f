"""Headless visualization (numpy only): the single-file WebGL viewer and
the during-run snapshots, copied from ``mulls_tpu/viz``."""

from mulls_tpu_torch.viz.html_viewer import export_html_viewer  # noqa: F401
