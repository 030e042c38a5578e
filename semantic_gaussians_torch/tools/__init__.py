"""Tools of the port, run as modules: the benchmark tools (`bench`, the
headline rays/s; `bench_components`, `bench_eval`, `bench_distill`,
`bench_amg`, `bench_scaling`; `common` holds their random cloud), the
segment-sum probe ladder (`exp_panel`, `exp_panel2`; `probe_common` holds
what they share), the end-to-end harnesses (`parity_harness`,
`semantic_harness`), the step profiler (`profile_step`), a toy scene
writer (`make_toy_scene`) and the ScanNet scene preparation: a `.sens`
capture exported to the scene loader's layout (`scannet_sens_reader`) and
the label-filt PNGs of the exported frames pulled from their zip
(`unzip_label_filt`)."""
