# Copy of starkpack_winterfell_tpu/air/__init__.py; cut: nothing.
from .air import (
    Air,
    AirContext,
    AuxTraceRandElements,
    ConstraintCompositionCoefficients,
    DeepCompositionCoefficients,
)
from .assertions import Assertion
from .boundary import BoundaryConstraint, BoundaryConstraintGroup, BoundaryConstraints
from .divisors import ConstraintDivisor
from .options import FieldExtension, ProofOptions
from .proof import (
    Commitments,
    Context,
    JointTraceQueries,
    OodFrame,
    Queries,
    StarkProof,
    Table,
)
from .trace_info import TraceInfo, TraceLayout
from .transition import (
    EvaluationFrame,
    TransitionConstraintDegree,
    TransitionConstraints,
)
