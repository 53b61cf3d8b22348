"""``idle_in_render_ms.gen``'s reading over the training steps (the datagen inside
``train.step``), so that the layer moves ``train_img_per_s``."""

from harness.manifest import reader

read = reader("idle_in_render_ms.gen")
