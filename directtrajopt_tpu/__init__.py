"""directtrajopt_tpu — batched on-device direct trajectory optimization.

A from-scratch JAX/XLA/Pallas framework with the capabilities of
harmoniqs/DirectTrajOpt.jl: direct transcription of optimal-control problems
(bilinear / derivative / time-dependent dynamics, composable objectives, a
full linear + nonlinear constraint stack) solved by an on-device batched
primal-dual interior-point method with block-structured KKT factorization,
vmapped over scenario batches and shardable over device meshes.
"""

from .constraints import (
    AllEqualConstraint,
    fix_global_variable,
    fix_trajectory_variable,
    BoundsConstraint,
    DurationConstraint,
    EqualityConstraint,
    GlobalBoundsConstraint,
    GlobalEqualityConstraint,
    GlobalLinearConstraint,
    L1SlackConstraint,
    NonlinearGlobalConstraint,
    NonlinearGlobalKnotPointConstraint,
    NonlinearKnotPointConstraint,
    SymmetricControlConstraint,
    SymmetryConstraint,
    TimeConsistencyConstraint,
    TimeStepsAllEqualConstraint,
    TotalConstraint,
)
from .integrators import (
    BilinearIntegrator,
    DerivativeIntegrator,
    GeneralIntegrator,
    TimeDependentBilinearIntegrator,
    td_integration_error,
    tune_n_steps,
)
from .module import HashableArray, module, static_field
from .objectives import (
    CompositeObjective,
    GlobalKnotPointObjective,
    GlobalObjective,
    GlobalTerminalObjective,
    KnotPointObjective,
    LinearRegularizer,
    MinimumTimeObjective,
    NullObjective,
    QuadraticRegularizer,
    TerminalObjective,
    objective_value,
)
from .problem import DirectTrajOptProblem, get_trajectory_constraints
from .rollout import bilinear_rollout, rollout, rollout_fidelity
from .solvers import (
    IPMCallbacks,
    IPMOptions,
    SolveResult,
    best_fidelity_tracker,
    fidelity_stop,
    make_nlp,
    say_hello,
    solve,
    stop_iteration,
    telemetry,
    TELEMETRY_COLUMNS,
    solve_batch,
    remove_slack_variables,
    get_default_options,
    set_default_options,
    solve_jit,
    solve_polished,
    solve_batch_polished,
    solve_batch_scheduled,
    solve_batch_compact,
    cast_problem,
)
from .trajectory import Layout, Trajectory, traj_index, traj_slice
from .utils.mpc import mpc_step, shift_trajectory

__version__ = "0.1.0"
