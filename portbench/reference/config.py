"""The reference's constants: ``streamz-rs/src/lib.rs:25-36`` (44.1 kHz,
windows of 800, hop 400, 26 mels, 20 MFCC plus deltas) and
``src/main.rs:21-37`` (the training settings).  Frozen from
``streamz_tpu_torch/config.py`` at commit 9a1a12a3fe3c; only the numbers
the reference reads."""

DEFAULT_SAMPLE_RATE = 44_100
WINDOW_SIZE = 800
HOP_SIZE = WINDOW_SIZE // 2
N_MELS = 26
MFCC_SIZE = 20
FEATURE_SIZE = MFCC_SIZE * 3
HIDDEN1 = 512
HIDDEN2 = 256
DEFAULT_CONF_THRESHOLD = 0.8
DEFAULT_BURN_IN_FRAC = 0.2
DEFAULT_DROPOUT = 0.2
TRAIN_EPOCHS = 100
CORPUS_BATCH = 4096
CORPUS_LR = 0.01
BATCH_SIZE = 8
INCREMENTAL_EPOCHS = 5
LR_EARLY = 0.05
LR_LATE = 0.01
LR_SWITCH_COUNT = 1000
