"""runner_s.rec: seconds per traced job in run_pipeline's own work around
the stage (parallel.runner), summed over the worker threads: the
program's phases "split" (split_by_contig and assign_shards), "gather"
(each group's take) and "concat" (concat_tables)."""

from program_spans import per_traced_job, phase_s


def read(run, spans=None):
    return per_traced_job(run, spans, phase_s("split", "gather", "concat"))
