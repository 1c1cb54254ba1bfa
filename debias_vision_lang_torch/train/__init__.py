"""Adversarial prompt-array training (the port of
``debias_vision_lang_tpu/train``), with the adversary ablation in
``efficacy.py``."""
