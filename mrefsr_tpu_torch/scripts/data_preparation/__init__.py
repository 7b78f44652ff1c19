"""Dataset preparation: containers (``create_pack``, ``create_lmdb``),
crops and meta-info (``extract_subimages``, ``generate_meta_info``),
degraded and resized copies (``generate_bicubic_img``,
``prepare_hifacegan_dataset``), REDS's regrouping, TFRecord extraction and
the dataset downloads."""
