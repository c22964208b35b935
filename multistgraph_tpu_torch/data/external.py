"""External-feature fusion: time-of-day, day-of-week, .ext columns.

Counterpart of multistgraph_tpu/data/external.py (reference:
traffic_state_datatset.py:594-639). Feature order in the fused array is
[data_cols..., time_in_day?, day_in_week?, ext cols...].
"""

from typing import Optional

import numpy as np

from multistgraph_tpu_torch.data.atomic import DynaData, ExtData


def fuse_external(
    dyna: DynaData,
    ext: Optional[ExtData] = None,
    add_time_in_day: bool = False,
    add_day_in_week: bool = False,
    load_dynamic: bool = True,
) -> np.ndarray:
    """Append per-timestep global features to every node of a (T, N, F) series."""
    series = dyna.values
    len_time, num_nodes, _ = series.shape
    timestamps = dyna.timestamps
    has_time = timestamps is not None and not np.isnan(timestamps.astype("float64")).any()
    parts = [series]

    if add_time_in_day and has_time:
        day_frac = (timestamps - timestamps.astype("datetime64[D]")) / np.timedelta64(1, "D")
        parts.append(np.tile(day_frac[:, None, None], (1, num_nodes, 1)))

    if add_day_in_week and has_time:
        # day 0 of the datetime64 epoch (1970-01-01) was a Thursday
        days = timestamps.astype("datetime64[D]").astype(np.int64)
        weekday = (days + 3) % 7  # Monday=0 like datetime.weekday()
        one_hot = np.zeros((len_time, num_nodes, 7))
        one_hot[np.arange(len_time), :, weekday] = 1.0
        parts.append(one_hot)

    if ext is not None and load_dynamic:
        if has_time and ext.timestamps is not None:
            # align .ext rows to the dyna timeline by timestamp
            order = np.argsort(ext.timestamps)
            pos = np.searchsorted(ext.timestamps[order], timestamps)
            if (pos >= len(order)).any() or (
                    ext.timestamps[order][np.clip(pos, 0, len(order) - 1)] != timestamps).any():
                raise KeyError("dyna timestamp missing from .ext file")
            selected = ext.values[order[pos]]
            parts.append(np.tile(selected[:, None, :], (1, num_nodes, 1)))
        elif ext.values.shape[0] == len_time:
            parts.append(np.tile(ext.values[:, None, :], (1, num_nodes, 1)))

    return np.concatenate(parts, axis=-1)
