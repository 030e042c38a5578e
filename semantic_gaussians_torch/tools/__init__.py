"""Tools of the port, run as modules: the segment-sum probe ladder
(`exp_panel`, `exp_panel2`; `probe_common` holds what they share), the
end-to-end harnesses (`parity_harness`, `semantic_harness`), the step
profiler (`profile_step`) and a toy scene writer (`make_toy_scene`)."""
