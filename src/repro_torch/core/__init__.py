"""The TNN computational model: temporal coding, RNL columns + WTA,
counter-form STDP, layers, networks, encoder and site-vote readout."""
from repro_torch.core.temporal import SPIKE_DTYPE, WaveSpec, encode_intensity
from repro_torch.core.stdp import (
    STDPConfig,
    apply_net,
    default_stabilize_table,
    stdp_cases,
    stdp_net_from_uniforms,
)
from repro_torch.core.column import (
    ColumnConfig,
    body_potential,
    column_forward,
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
    layer_uniforms,
)
from repro_torch.core.network import (
    NetworkConfig,
    build_vote_table,
    classify,
    dog_filter,
    encode_images,
    forward_all_padded,
    init_network,
    input_wave_spec,
    network_forward,
    network_train_wave,
    params_from_tree,
    params_to_tree,
    prototype_config,
    refresh_vote_table,
    vote_sums,
    winner_map,
    with_impl,
)
