"""CURing — compression via CUR decomposition with WANDA x DEIM selection
and angular-distance layer choice."""
from repro_torch.core.angular import (
    angular_distance, layer_distances, select_layers)
from repro_torch.core.calibrate import CalibStats, calibrate
from repro_torch.core.compress import (
    CompressInfo, WeightInfo, compress_model, compress_weight, fold_cur,
    select_indices)
from repro_torch.core.cur import (
    compute_u, cur_from_indices, exact_svd, randomized_svd, rank_for)
from repro_torch.core.deim import deim
from repro_torch.core.wanda import wanda_scores

__all__ = [
    "CalibStats", "CompressInfo", "WeightInfo", "angular_distance",
    "calibrate", "compress_model", "compress_weight", "compute_u",
    "cur_from_indices", "deim", "exact_svd", "fold_cur", "layer_distances",
    "randomized_svd", "rank_for", "select_indices", "select_layers",
    "wanda_scores"]
