"""SlotFormer dynamics on CLEVRER slots.

Hyperparameters match the reference run (80 epochs ~ 450k steps, batch 128,
lr 2e-4, 6 burn-in + 10 rollout at frame offset 2, image recon loss on);
see video_prediction/configs/slotformer_clevrer_params.py in the reference.
"""

from slotformer_tpu_torch.runtime.params import BaseParams

NUM_SLOTS = 7
SLOT_SIZE = 128
BURN_IN = 6
ROLLOUT = 10
D_MODEL = SLOT_SIZE * 2


class SlotFormerParams(BaseParams):
    project = 'SlotFormer-TPU'
    model = 'SlotFormer'

    # ---- data: precomputed SAVi slots + images for the recon loss
    dataset = 'clevrer_slots'
    data_root = './data/CLEVRER'
    slots_root = './data/CLEVRER/clevrer_slots.pkl'
    resolution = (64, 64)
    n_sample_frames = BURN_IN + ROLLOUT
    input_frames = BURN_IN
    frame_offset = 2          # subsample the video 2x
    load_img = True
    filter_enter = True       # train only on sequences w/o entering objects
    num_workers = 8
    train_batch_size = 128    # GLOBAL batch, sharded over the mesh
    val_batch_size = 256

    # ---- model
    slot_dict = dict(num_slots=NUM_SLOTS, slot_size=SLOT_SIZE)
    rollout_dict = dict(
        num_slots=NUM_SLOTS,
        slot_size=SLOT_SIZE,
        history_len=BURN_IN,
        t_pe='sin',
        slots_pe='',
        d_model=D_MODEL,
        num_layers=4,
        num_heads=8,
        ffn_dim=D_MODEL * 4,
        norm_first=True,
    )
    # frozen SAVi decoder, grafted from the pretrained encoder checkpoint (one
    # of cli.train's model_<it>.pth files, or a reference .pth)
    dec_dict = dict(
        dec_channels=(128, 64, 64, 64, 64),
        dec_resolution=(8, 8),
        dec_ks=5,
        dec_norm='',
        dec_ckp_path='pretrained/stosavi_clevrer_params/model.pth',
    )

    # ---- losses: slot MSE + decoded-image MSE (key for pixel quality)
    loss_dict = dict(rollout_len=ROLLOUT, use_img_recon_loss=True)
    slot_recon_loss_w = 1.
    img_recon_loss_w = 1.

    # ---- optimization: Adam, cosine decay, 5% warmup, no clip/decay
    optimizer = 'Adam'
    lr = 2e-4
    warmup_steps_pct = 0.05
    max_epochs = 80
    save_interval = 0.25
    eval_interval = 4
    n_samples = 5
