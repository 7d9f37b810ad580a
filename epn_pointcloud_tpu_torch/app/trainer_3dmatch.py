"""3DMatch descriptor training and evaluation (counterpart of
``epn_pointcloud_tpu/app/trainer_3dmatch.py`` ``Trainer3DMatch``).

A step is two model calls, one a leg (the src and the tgt patches of npt
keypoint pairs), the in-batch hard-negative triplet loss on the two
descriptor sets, a backward through the conv kernels' autograd Functions
and an Adam step at the scheduled learning rate, in fp32 or, with
``--compute-dtype bf16``, in the production mode (bf16 activations and
weights at use; fp32 parameters, Adam, statistics and descriptors). Its log
scalars (Loss = Pos - Neg, Pos, Neg, Acc) stay on the device until the
Summary reads them at log time. The block-parameter tree goes to
``<run dir>/params.json``, as the JAX trainer writes it.

``eval(scenes)`` is the descriptor evaluation: for each scene, every
fragment's keypoint patches (``SceneEvalLoader``) through the eval-mode
model in chunks of batch_size * npt patches, the descriptors to
``data/evaluate/3DMatch/<experiment>/<scene>/<dim>_dim/feature<N>.npy``,
the feature-match recall (``eval.evaluation_3dmatch.evaluate_scene``, which
writes recall.txt beside them), and the recall at each tau to
``trained_models/evaluate/3DMatch/<experiment>/recall.csv``; both paths are
relative to the working directory, as in the JAX package. The eval mode
builds no training loader.

Under data parallelism (``app.trainer``) every rank loads the same
fragment pair (one a step, so the loader does not shard it) and keeps its
``process_slice`` of the b * npt patches of each leg; the descriptors of
both legs go through a differentiable all-gather, so the triplet loss
mines its negatives over the global batch and every rank computes the same
loss; the gather's backward sums the descriptor gradients over the ranks
and ``all_reduce_grads`` divides their sum by the world size: the
single-process gradient. The evaluation stays single-process and refuses
a data group of more than one rank.

Refused: the equivariance loss (``--equi-alpha > 0``): the JAX package's
own path raises on its live model (``losses.triplet_equivariance_loss``
hands the [b, p, a, c] InvOutBlockMVD attention to ``so3_interpolate``,
which takes [b, a, c]), so it has no reference to hold a port to.
"""

from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch

from .. import losses, models
from .. import train as train_lib
from ..parallel import (collectives, is_main, mesh, process_slice,
                        shard_batch)
from .trainer import Trainer


class Trainer3DMatch(Trainer):
    def __init__(self, opt, device=None):
        if opt.train_loss.equi_alpha > 0:
            raise NotImplementedError(
                'the equivariance loss (--equi-alpha > 0) is not ported: the '
                "JAX package's triplet_equivariance_loss fails on its live "
                'model (it passes the [b, p, a, c] InvOutBlockMVD attention '
                'to so3_interpolate, which takes [b, a, c]), so there is no '
                'reference to hold a port to')
        if getattr(opt, 'steps_per_dispatch', 1) > 1:
            raise NotImplementedError('--steps-per-dispatch > 1 is TPU '
                                      'dispatch machinery; the port takes one '
                                      'step a call')
        self.epoch_counter = 0
        super().__init__(opt, device)
        self.summary.register(['Loss', 'Pos', 'Neg', 'Acc'])

    def _setup_datasets(self):
        opt = self.opt
        if opt.mode != 'train':
            self.dataset = None
            return
        from ..data.match_3dmatch import FragmentLoader
        from ..data.modelnet40 import DataLoader
        dataset = FragmentLoader(opt, opt.model.search_radius,
                                 kptname=opt.dataset,
                                 use_normals=opt.model.normals, npt=opt.npt)
        self.dataset = DataLoader(dataset, opt.batch_size, shuffle=True,
                                  seed=opt.seed, process_shard=False)
        self.dataset_iter = iter(self.dataset)

    def _setup_eval_datasets(self, scene):
        from ..data.match_3dmatch import SceneEvalLoader
        self.dataset_eval = SceneEvalLoader(self.opt, scene)

    def _setup_model(self):
        self.model = models.build_model_from(
            self.opt, seed=self.opt.seed,
            outfile_path=(os.path.join(self.root_dir, 'params.json')
                          if is_main() else None))
        self.model.to(self.device)

    def _prepare_input(self, data):
        """[b, npt, n, c] legs -> [b * npt, n, c] tensors on the device:
        this rank's ``process_slice`` of the patches."""
        legs = [data[k].reshape((-1,) + data[k].shape[-2:])
                for k in ('src', 'tgt')]
        if mesh.data_world() > 1:
            legs = [x[process_slice(x.shape[0])] for x in legs]
        return shard_batch(tuple(legs), self.device)

    def step(self):
        try:
            data = next(self.dataset_iter)
        except StopIteration:
            self.epoch_counter += 1
            self.logger.log('DataLoader', f'At Epoch {self.epoch_counter}!')
            self.dataset_iter = iter(self.dataset)
            data = next(self.dataset_iter)
        self._optimize(data)
        self.iter_counter += 1

    def _optimize(self, data):
        src, tgt = self._prepare_input(data)
        self.model.train()
        y_src, _ = self.model(src)
        y_tgt, _ = self.model(tgt)
        if mesh.data_world() > 1:
            # the global batch's descriptors: negatives mined over it all
            y_src, y_tgt = (collectives.all_gather_batch(y, self.group)
                            for y in (y_src, y_tgt))
        loss, aux = losses.triplet_batch_loss(
            y_src, y_tgt, self.opt.train_loss.loss_type,
            self.opt.train_loss.margin)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        mesh.all_reduce_grads(self.model, self.group)
        train_lib.set_lr(self.optimizer, self.lr_schedule(self.iter_counter))
        self.optimizer.step()
        fpos, cneg = aux['fpos'].detach(), aux['cneg'].detach()
        self._log_step(loss, {'Loss': fpos - cneg, 'Pos': fpos, 'Neg': cneg,
                              'Acc': 100.0 * aux['accuracy']})

    def test(self):
        pass

    # ------------------------------------------------------------ evaluation

    def eval(self, select):
        """Descriptors and feature-match recall of each scene in
        ``select``; returns {scene: [(tau, recall percent)]}. The seconds
        it spent, by part (patch search and loading, the model's forward
        with its transfers, on the card also its device time by CUDA
        events, the matching), are logged and kept in ``eval_seconds``."""
        from ..eval import evaluation_3dmatch as eval3dmatch
        if mesh.data_world() > 1:
            raise RuntimeError(
                'the 3DMatch evaluation runs in one process: start '
                'run_3dmatch --run-mode eval without torchrun')
        self.eval_seconds = {'load_s': 0.0, 'forward_s': 0.0,
                             'device_s': 0.0, 'match_s': 0.0, 'patches': 0}
        all_results = {}
        for scene in select:
            assert os.path.isdir(os.path.join(self.opt.dataset_path, scene))
            self.logger.log('Eval', f'Working on scene {scene}...')
            target_folder = os.path.join('data/evaluate/3DMatch/',
                                         self.opt.experiment_id, scene,
                                         f'{self.opt.model.output_num}_dim')
            self._setup_eval_datasets(scene)
            self._generate(target_folder)
            t0 = time.perf_counter()
            all_results[scene] = eval3dmatch.evaluate_scene(
                self.opt.dataset_path, target_folder, scene,
                num_thread=min(8, os.cpu_count() or 1))
            self.eval_seconds['match_s'] += time.perf_counter() - t0
        self._write_csv(all_results)
        s = self.eval_seconds
        self.logger.log('Eval', f'{s["patches"]} patches: patch loading '
                        f'{s["load_s"]:.3f} s, forward {s["forward_s"]:.3f} s '
                        f'({s["patches"] / max(s["forward_s"], 1e-9):.1f} '
                        f'patches/s; device {s["device_s"]:.3f} s), matching '
                        f'{s["match_s"]:.3f} s (host)')
        self.logger.log('Eval', 'Done!')
        return all_results

    @torch.inference_mode()
    def _generate(self, target_folder):
        """Each fragment's descriptors, batch_size * npt patches a forward
        (a NaN descriptor becomes 0), to feature<sid>.npy. The last chunk
        runs at its own size: in eval mode a patch's descriptor depends on
        that patch alone (InstanceNorm normalizes each cloud on its own,
        and fps and the ball query run per cloud), so it equals the JAX
        package's, which pads the chunk to one compiled shape."""
        bs = self.opt.batch_size * self.opt.npt
        os.makedirs(target_folder, exist_ok=True)
        self.model.eval()
        cuda = self.device.type == 'cuda'
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
        for idx in range(len(self.dataset_eval)):
            t0 = time.perf_counter()
            data = self.dataset_eval[idx]
            sid, clouds = data['sid'], np.asarray(data['clouds'])
            t1 = time.perf_counter()
            feature_buffer = []
            for bi in range(0, clouds.shape[0], bs):
                x = torch.from_numpy(clouds[bi: bi + bs]).to(self.device)
                if cuda:
                    start.record()
                y = self.model(x)[0]
                if cuda:
                    end.record()
                feat = y.float().cpu().numpy()
                if cuda:
                    self.eval_seconds['device_s'] += \
                        start.elapsed_time(end) / 1e3
                feature_buffer.append(np.nan_to_num(feat)
                                      if np.isnan(feat).any() else feat)
            t2 = time.perf_counter()
            self.eval_seconds['load_s'] += t1 - t0
            self.eval_seconds['forward_s'] += t2 - t1
            self.eval_seconds['patches'] += clouds.shape[0]
            out_path = os.path.join(target_folder, f'feature{sid}.npy')
            self.logger.log('Eval', f'Saving features to {out_path}')
            np.save(out_path, np.vstack(feature_buffer))

    def _write_csv(self, results):
        """recall.csv: a row a scene, the recall at each tau."""
        from ..eval import evaluation_3dmatch as eval3dmatch
        csvpath_root = os.path.join('trained_models/evaluate/3DMatch/',
                                    self.opt.experiment_id)
        os.makedirs(csvpath_root, exist_ok=True)
        with open(os.path.join(csvpath_root, 'recall.csv'), 'w',
                  newline='') as csvfile:
            fieldnames = ['Scene'] + ['tau_%.2f' % tau
                                      for tau in eval3dmatch.TAU_RANGE]
            writer = csv.DictWriter(csvfile, fieldnames=fieldnames)
            writer.writeheader()
            for scene, recalls in results.items():
                row = {'Scene': scene}
                for tau, ratio in recalls:
                    row['tau_%.2f' % tau] = '%.2f' % ratio
                writer.writerow(row)
        all_recall = []
        for scene, recalls in results.items():
            tau, ratio = recalls[0]
            self.logger.log('Eval', '%s recall is %.2f at tau %.2f'
                            % (scene, ratio, tau))
            all_recall.append(ratio)
        self.logger.log('Eval', 'Average recall is %.2f !'
                        % float(np.mean(all_recall)))
