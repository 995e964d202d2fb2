"""Small sizes at which the CPU tests rehearse the benchmark's cells."""

TINY_WIDTHS = {"embed_dim": 64, "depth": 3, "num_heads": 4, "mlp_dim": 256, "base_img_size": 64}

TRAIN = {"config": {"config": {"backbone": "vit_tiny_test", "crop_size": 64, "batch_size": 2},
                    "widths": TINY_WIDTHS},
         "traffic": {"ring": 3, "warmup_steps": 1, "trace_steps": 2}}

VAL = {"config": {"config": {"backbone": "vit_tiny_test", "crop_size": 64,
                             "eval_scales": [1.0, 0.5]},
                  "widths": TINY_WIDTHS, "data": {"image_size": [64, 96]}},
       "traffic": {"val_images": 24, "warmup_images": 8, "check_batches": 2, "trace_images": 8,
                   "trace_calls": 1}}

OVERRIDES = {"voc.train_staged": TRAIN, "coco.train_staged": TRAIN, "voc.val_tta": VAL}
