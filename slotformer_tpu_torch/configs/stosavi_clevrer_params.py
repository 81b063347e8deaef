"""StoSAVi on CLEVRER (reference base_slots/configs/stosavi_clevrer_params.py)."""

from slotformer_tpu_torch.runtime.params import BaseParams


class SlotFormerParams(BaseParams):
    project = 'SlotFormer-TPU'

    # training: 12 epochs ~ 230k steps
    max_epochs = 12
    save_interval = 0.2
    eval_interval = 1
    n_samples = 5

    # Adam + cosine decay with warmup; small lr is critical for SAVi
    optimizer = 'Adam'
    lr = 1e-4
    clip_grad = 0.05
    warmup_steps_pct = 0.025

    # data
    dataset = 'clevrer'
    data_root = './data/CLEVRER'
    n_sample_frames = 6
    frame_offset = 1
    filter_enter = False  # no filtering needed for SAVi training
    train_batch_size = 64  # GLOBAL batch (sharded over the mesh)
    val_batch_size = 128
    num_workers = 8

    # model
    model = 'StoSAVi'
    resolution = (64, 64)
    input_frames = n_sample_frames

    slot_dict = dict(
        num_slots=7,  # at most 6 objects per scene
        slot_size=128,
        slot_mlp_size=256,
        num_iterations=2,
        kernel_mlp=False,
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
        pred_type='mlp',  # less fusion so slots don't share objects
        pred_rnn=False,
        pred_norm_first=True,
        pred_num_layers=2,
        pred_num_heads=4,
        pred_ffn_dim=128 * 4,
        pred_sg_every=None,
    )
    loss_dict = dict(
        use_post_recon_loss=True,
        kld_method='var-0.01',  # prior Gaussian variance 0.01
    )

    post_recon_loss_w = 1.
    kld_loss_w = 1e-4
