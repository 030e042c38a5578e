"""Measurement tools of the port, run as modules: the segment-sum probe
ladder (`exp_panel`, `exp_panel2`). `probe_common` holds what they share."""
