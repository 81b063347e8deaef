"""SAVi on OBJ3D (reference base_slots/configs/savi_obj3d_params.py)."""

from slotformer_tpu_torch.runtime.params import BaseParams


class SlotFormerParams(BaseParams):
    project = 'SlotFormer-TPU'

    max_epochs = 40  # ~80k steps
    save_interval = 0.2
    eval_interval = 2
    n_samples = 5

    optimizer = 'Adam'
    lr = 1e-4
    clip_grad = 0.05
    warmup_steps_pct = 0.025

    dataset = 'obj3d'
    data_root = './data/OBJ3D'
    n_sample_frames = 6
    frame_offset = 1
    video_len = 50
    train_batch_size = 64  # GLOBAL
    val_batch_size = 128
    num_workers = 8

    model = 'StoSAVi'  # deterministic variant via kld_method='none'
    resolution = (64, 64)
    input_frames = n_sample_frames

    slot_dict = dict(
        num_slots=6,  # at most 5 objects per scene
        slot_size=128,
        slot_mlp_size=256,
        num_iterations=2,
    )
    enc_dict = dict(
        enc_channels=(3, 64, 64, 64, 64),
        enc_ks=5,
        enc_out_channels=128,
        enc_norm='',
    )
    dec_dict = dict(
        dec_channels=(128, 64, 64, 64, 64),
        dec_resolution=(8, 8),
        dec_ks=5,
        dec_norm='',
    )
    pred_dict = dict(
        pred_type='transformer',
        pred_rnn=True,
        pred_norm_first=True,
        pred_num_layers=2,
        pred_num_heads=4,
        pred_ffn_dim=128 * 4,
        pred_sg_every=None,
    )
    loss_dict = dict(
        use_post_recon_loss=True,
        kld_method='none',  # standard SAVi
    )

    post_recon_loss_w = 1.
    kld_loss_w = 1e-4
