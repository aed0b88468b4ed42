"""k6_roofline.rec: K6 (csrc/chain_dp.cu) as a share of its least time, over
its device seconds in the trace.  The least time of a launch is the
larger of its bytes at the card's HBM rate (56 a record: query and
target start and end and the score read, the chain score and the
predecessor written, 8 bytes each) and its operations at the card's
int32 rate (SMs x 64 lanes x the highest SM clock nvidia-smi gives):
12 a candidate of the max-gap windows (two differences, two bounds of
the target gap, their sum, its zero test, the gap cost's multiply-add,
the test against the score, the value's two terms, the compare with
the best and its select), each counted once though its operands are
64-bit, so a floor."""

from readings import roofline

BYTES_PER_RECORD = 56
OPS_PER_CANDIDATE = 12


def least_s(w, pk):
    return max(BYTES_PER_RECORD * w["records"] / pk["hbm_bytes_per_s"],
               OPS_PER_CANDIDATE * w["candidates"] / pk["int32_ops_per_s"])


def read(run):
    return roofline(run, ("chain_dp_kernel",), least_s)
