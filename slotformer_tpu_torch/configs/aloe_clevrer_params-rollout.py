"""Aloe VQA head on CLEVRER ROLLOUT slots (predictive/counterfactual questions read the unrolled tail).

Values match clevrer_vqa/configs/aloe_clevrer_params-rollout.py in the reference:
400 epochs ~ 240k steps, batch 256, 12-layer encoder over
(6+1 slots) x 25 frames + 20 question + 12 choice tokens.
``vocab_file`` is this package's copy of the CLEVRER vocab (82 question
words, 22 answers).
"""

import os

from slotformer_tpu_torch.runtime.params import BaseParams

_CUR_DIR = os.path.dirname(os.path.realpath(__file__))
SLOT_SIZE = 128
N_FRAMES = 25
MAX_Q_LEN = 20
MAX_C_LEN = 12
MAX_OBJS = 6


class SlotFormerParams(BaseParams):
    project = 'SlotFormer-TPU'
    model = 'CLEVRERAloe'

    # ---- data (row-based question/choice items, see datasets/clevrer_vqa.py)
    dataset = 'clevrer_vqa'
    data_root = './data/CLEVRER'
    slots_root = './data/CLEVRER/rollout_clevrer_slots.pkl'
    vocab_file = os.path.join(_CUR_DIR, '../datasets/cache/CLEVRER_vocab.json')
    n_sample_frames = N_FRAMES
    max_n_objects = MAX_OBJS
    max_question_len = MAX_Q_LEN
    max_choice_len = MAX_C_LEN
    shuffle_obj = False       # SAVi slots are temporally consistent
    num_workers = 8
    train_batch_size = 256    # GLOBAL (rows)
    val_batch_size = 512

    # ---- model
    slot_size = SLOT_SIZE
    transformer_dict = dict(
        input_len=(MAX_OBJS + 1) * N_FRAMES + MAX_Q_LEN + MAX_C_LEN,
        input_dim=16,
        pos_enc='learnable',
        num_layers=12,
        num_heads=8,
        ffn_dim=512,
        norm_first=True,
        cls_mlp_size=128,
    )
    vision_dict = dict(vision_dim=SLOT_SIZE)
    loss_dict = dict(use_mask_obj_loss=False)
    cls_answer_loss_w = 1.
    mc_answer_loss_w = 1.
    mask_obj_loss_w = 0.01

    # ---- optimization
    optimizer = 'Adam'
    lr = 1e-3
    warmup_steps_pct = 0.1
    max_epochs = 400
    eval_interval = 20
    n_samples = 5
