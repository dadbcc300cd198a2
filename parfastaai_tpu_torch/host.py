"""The JAX package's host-side modules that the port reuses unchanged.

None of them imports jax: the kernels' single-block K limit, the SQLite
ETL and width buckets, the pair spaces of the three run modes, E
derivation, the native f64 finish and CSV formatter, the phase timers, the
error types and the synthetic database generator.  The port's modules and scripts take them from here, so this
module is the one seam between the port and the JAX package.
"""

from parfastaai_tpu.constants import MAX_K_SINGLE_BLOCK
from parfastaai_tpu.etl.database import (
    PresenceData,
    QueryTargetDatabase,
    SCPDatabase,
    bucket_bounds,
    bucketize_presence,
)
from parfastaai_tpu.etl.derive import derive_qsub, derive_qt, derive_single
from parfastaai_tpu.io.csv_writer import write_aji_csv
from parfastaai_tpu.io.fmtfloat import format_double
from parfastaai_tpu.modes import (
    PairSpace,
    all_vs_all,
    query_subset,
    query_subset_axes,
    query_target,
    query_target_axes,
)
from parfastaai_tpu.native import get_lib as native_lib
from parfastaai_tpu.native import native_jaccard_finish
from parfastaai_tpu.tools.synth_db import generate as generate_synth_db
from parfastaai_tpu.types import ErrorCode, JacResult, PFAAIError
from parfastaai_tpu.utils.timing import phase_timer

__all__ = [
    "MAX_K_SINGLE_BLOCK",
    "ErrorCode",
    "JacResult",
    "PFAAIError",
    "PairSpace",
    "PresenceData",
    "QueryTargetDatabase",
    "SCPDatabase",
    "all_vs_all",
    "bucket_bounds",
    "bucketize_presence",
    "derive_qsub",
    "derive_qt",
    "derive_single",
    "format_double",
    "generate_synth_db",
    "native_jaccard_finish",
    "native_lib",
    "phase_timer",
    "query_subset",
    "query_subset_axes",
    "query_target",
    "query_target_axes",
    "write_aji_csv",
]
