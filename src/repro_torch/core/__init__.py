"""The TNN computational model: temporal coding, RNL columns + WTA,
counter-form STDP, layers, networks, encoder, the site-vote and centroid
readouts, and the calibrated 7 nm PPA model (``hwmodel``, ``macros``)."""
from repro_torch.core.temporal import SPIKE_DTYPE, WaveSpec, encode_intensity
from repro_torch.core.stdp import (
    STDPConfig,
    apply_net,
    default_stabilize_table,
    stdp_cases,
    stdp_net_from_uniforms,
    stdp_update,
)
from repro_torch.core.column import (
    ColumnConfig,
    body_potential,
    column_forward,
    column_forward_matmul,
    column_step,
    crossing_time,
    init_weights,
    wta_inhibit,
)
from repro_torch.core.layer import (
    LayerConfig,
    encode_patches_onoff,
    extract_patches,
    init_layer,
    layer_forward,
    layer_stdp_net,
    layer_step,
    layer_uniforms,
)
from repro_torch.core.network import (
    NetworkConfig,
    build_centroids,
    build_vote_table,
    classify,
    classify_centroid,
    dog_filter,
    encode_images,
    forward_all_padded,
    init_network,
    init_train_state,
    input_wave_spec,
    make_online_step,
    make_online_superbatch_step,
    make_superbatch_step,
    make_train_step,
    network_forward,
    network_forward_superbatch,
    network_train_superbatch,
    network_train_wave,
    params_from_tree,
    params_to_tree,
    prototype_config,
    refresh_vote_table,
    superbatch_keys,
    train_stream_start,
    vote_sums,
    winner_bits,
    winner_map,
    with_impl,
)
from repro_torch.core import hwmodel, macros  # noqa: E402
