"""ADM-style Gaussian diffusion, port of `dimsum_tpu/diffusion/`: the
DDPM / DDIM sampler the published DiT checkpoints were trained with.  No
CLI samples through it (neither does the JAX package's): the DiM and DiT
CLIs sample through `dimsum_torch.transport`."""

from dimsum_torch.diffusion.gaussian_diffusion import (  # noqa: F401
    GaussianDiffusion,
    LossSecondMomentResampler,
    LossType,
    ModelMeanType,
    ModelVarType,
    UniformSampler,
    get_named_beta_schedule,
    space_timesteps,
    spaced_diffusion,
)


def create_diffusion(timestep_respacing="", noise_schedule="linear",
                     diffusion_steps=1000, learn_sigma=False,
                     predict_xstart=False, sigma_small=False,
                     use_kl=False, rescale_learned_sigmas=False):
    """guided-diffusion's `create_diffusion` (the JAX one): the schedule,
    the loss, mean and variance types, respaced when
    `timestep_respacing` is given ("ddimN" or section counts)."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if use_kl:
        loss = LossType.RESCALED_KL
    elif rescale_learned_sigmas:
        loss = LossType.RESCALED_MSE
    else:
        loss = LossType.MSE
    mean_type = (ModelMeanType.START_X if predict_xstart
                 else ModelMeanType.EPSILON)
    if learn_sigma:
        var_type = ModelVarType.LEARNED_RANGE
    else:
        var_type = (ModelVarType.FIXED_SMALL if sigma_small
                    else ModelVarType.FIXED_LARGE)
    if timestep_respacing:
        return spaced_diffusion(
            betas, space_timesteps(diffusion_steps, timestep_respacing),
            model_mean_type=mean_type, model_var_type=var_type,
            loss_type=loss)
    return GaussianDiffusion(betas=betas, model_mean_type=mean_type,
                             model_var_type=var_type, loss_type=loss)
