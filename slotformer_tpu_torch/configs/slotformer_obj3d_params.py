"""SlotFormer dynamics on OBJ3D slots.

Values match video_prediction/configs/slotformer_obj3d_params.py in the
reference (200 epochs ~ 160k steps, batch 128, d_model = slot_size).

``dec_dict['dec_ckp_path']`` names the trained SAVi checkpoint whose decoder
(``decoder.*``, ``decoder_pos_embedding.*``) is grafted and frozen at the
start of training: a ``.pth`` of this package's trainer or of the reference,
read with ``torch.load``. JAX ``.ckpt.pkl`` files are converted first by
``cli.convert_reference_ckpt``.
"""

from slotformer_tpu_torch.runtime.params import BaseParams

NUM_SLOTS = 6
SLOT_SIZE = 128
BURN_IN = 6
ROLLOUT = 10


class SlotFormerParams(BaseParams):
    project = 'SlotFormer-TPU'
    model = 'SlotFormer'

    # ---- data
    dataset = 'obj3d_slots'
    data_root = './data/OBJ3D'
    slots_root = './data/OBJ3D/obj3d_slots.pkl'
    resolution = (64, 64)
    n_sample_frames = BURN_IN + ROLLOUT
    input_frames = BURN_IN
    frame_offset = 1
    video_len = 50
    num_workers = 8
    train_batch_size = 128    # GLOBAL
    val_batch_size = 256

    # ---- model
    slot_dict = dict(num_slots=NUM_SLOTS, slot_size=SLOT_SIZE)
    rollout_dict = dict(
        num_slots=NUM_SLOTS,
        slot_size=SLOT_SIZE,
        history_len=BURN_IN,
        t_pe='sin',
        slots_pe='',
        d_model=SLOT_SIZE,
        num_layers=4,
        num_heads=8,
        ffn_dim=SLOT_SIZE * 4,
        norm_first=True,
    )
    dec_dict = dict(
        dec_channels=(128, 64, 64, 64, 64),
        dec_resolution=(8, 8),
        dec_ks=5,
        dec_norm='',
        dec_ckp_path='pretrained/savi_obj3d_params/model.pth',
    )

    # ---- losses
    loss_dict = dict(rollout_len=ROLLOUT, use_img_recon_loss=True)
    slot_recon_loss_w = 1.
    img_recon_loss_w = 1.

    # ---- optimization
    optimizer = 'Adam'
    lr = 2e-4
    warmup_steps_pct = 0.05
    max_epochs = 200
    save_interval = 0.25
    eval_interval = 5
    n_samples = 5
