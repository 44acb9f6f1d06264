"""Mesh / sharding / multi-host scaling (SURVEY.md §2.5)."""

from numpower_tpu.parallel.mesh import (  # noqa: F401
    make_mesh, data_sharding, model_sharding, replicated, shard_batch,
)
from numpower_tpu.parallel.sharding import (  # noqa: F401
    kalman_filter_batched_dp, kalman_smoother_batched_dp,
    solve_mpc_boxqp_dp, solve_mpc_boxqp_admm_dp,
    solve_mpc_boxqp_dp_tp, sweep_statistics_dp,
)
from numpower_tpu.parallel.pipeline import rollout_lti_pipelined  # noqa: F401
from numpower_tpu.parallel.riccati_sp import (  # noqa: F401
    riccati_associative_sharded,
)
from numpower_tpu.parallel.kalman_sp import (  # noqa: F401
    kalman_filter_associative_sharded,
)
from numpower_tpu.parallel.distributed import (  # noqa: F401
    initialize, is_multi_host, local_scenario_slice, scaling_report,
)
from numpower_tpu.parallel.sampling import (  # noqa: F401
    mppi_solve_dp, particle_filter_dp,
)
from numpower_tpu.parallel.solvers_dp import (  # noqa: F401
    al_ilqr_solve_dp, mhe_solve_dp,
)
