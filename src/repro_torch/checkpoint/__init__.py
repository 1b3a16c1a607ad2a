"""TT payload checkpoints (``checkpoint.save_tt_payload`` /
``load_tt_payload``), readable by both packages."""
