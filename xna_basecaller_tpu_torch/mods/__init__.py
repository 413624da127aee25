"""Modified-base calling (the reference's Remora hook, re-designed).

Port of ``xna_basecaller_tpu/mods``: a per-site classifier over a window
of raw signal and the basecalled sequence context, attached to the
basecall pipeline, emitting SAM MM/ML tags.

- ``mods.model``: the conv + MLP classifier as an ``nn.Module``, and its
  files (``mods_config.json``, ``mods_weights.npz``) as JAX writes them.
- ``mods.infer``: move table -> sequence-to-signal map, motif-site feature
  extraction (numpy copies), ``call_mods`` (the forward on the model's
  device) with the MM/ML tags (SAMtags spec 1.7).
- ``mods.train``: the fit loop (AdamW as ``optax.adamw``'s defaults).
"""

from xna_basecaller_tpu_torch.mods.infer import call_mods, mods_tags_to_str
from xna_basecaller_tpu_torch.mods.model import (
    ModsConfig, ModsModel, init_mods_params, load_mods_model, mods_forward,
    save_mods_model,
)
