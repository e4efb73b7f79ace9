"""TAM core, PyTorch port: two-layer request aggregation for collective
I/O with every rank as a row of one tensor on one device."""
from repro_torch.core.requests import (  # noqa: F401
    ELEM_BYTES, PAD_OFFSET, RequestList, empty_requests, is_sorted,
    make_requests, requests_from_numpy, split_at_stripes, to_numpy,
)
from repro_torch.core.domains import FileLayout, contiguous_layout  # noqa: F401
from repro_torch.core.coalesce import (  # noqa: F401
    aggregate, coalesce_ratio, coalesce_sorted, merge_sorted, pack_data,
    request_starts, sort_requests, unpack_data,
)
from repro_torch.core.plan import (  # noqa: F401
    IOConfig, IOPlan, RoundScheduler, compile_plan, plan_diff,
    plan_from_fields, resolve_cb_buffer_size, resolve_method,
    resolve_slow_hop_codec,
)
from repro_torch.core.codec import (  # noqa: F401
    Codec, available_codecs, get_codec, lossless_codecs,
)
from repro_torch.core.placement import (  # noqa: F401
    PLACEMENT_POLICIES, node_of_slot, resolve_placement,
    validate_placement,
)
from repro_torch.core.session import IOSession  # noqa: F401
from repro_torch.core.spmd_exec import (  # noqa: F401
    RankMesh, make_collective_write, make_spmd_executor,
)
from repro_torch.core.twophase import (  # noqa: F401
    make_twophase_read, make_twophase_write, plan_for, write_reference,
)
from repro_torch.core.tam import make_tam_read, make_tam_write  # noqa: F401
from repro_torch.core.rounds import peak_aggregator_buffer_elems  # noqa: F401
from repro_torch.core.cost_model import (  # noqa: F401
    Machine, Workload, cb_candidates, optimal_PL, optimal_cb,
    optimal_cb_and_depth, optimal_depth, pipeline_span, placement_cost,
    rounds_for_cb, slow_hop_codec_gain, tam_cost, twophase_cost,
    with_codec, with_locality, with_measured_rounds, with_overlap,
)
from repro_torch.core.hierarchical import (  # noqa: F401
    ErrorFeedbackState, compressed_psum, two_layer_all_to_all,
    two_layer_psum,
)
