"""Host-side data pipeline (numpy/scipy): featurization, lane-graph
construction, synthetic scenarios and packing into static-shape batches."""

from lanegcn_tpu_torch.data.featurize import featurize_scenario  # noqa: F401
from lanegcn_tpu_torch.data.lane_graph import build_lane_graph  # noqa: F401
from lanegcn_tpu_torch.data.packing import pack_batch  # noqa: F401
from lanegcn_tpu_torch.data.synthetic import make_synthetic_scenario  # noqa: F401
