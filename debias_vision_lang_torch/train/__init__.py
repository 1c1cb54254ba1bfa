"""Adversarial prompt-array training (the port of
``debias_vision_lang_tpu/train``, without ``efficacy.py``)."""
