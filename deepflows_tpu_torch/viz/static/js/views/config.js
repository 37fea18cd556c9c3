/* Training-config view (reference: Visualization_frontend/src/views/
 * training-config/index.vue — model/optimizer/hyperparameter form feeding
 * the Pinia store's startTraining action).  Superset: scheduler choice,
 * target-accuracy early stop, and a run-history table (/api/history).
 */

import { api } from '../api.js';
import { Card, DataTable, el, labeled } from '../components.js';
import { useTrainingStore } from '../store/training.js';
import { layersSignal } from './builder.js';

const OPTIMIZERS = [
  'adam', 'sgd', 'adagrad', 'adadelta', 'adamw',
  'rmsprop', 'adafactor', 'lion', 'muon',
];
const SCHEDULERS = ['none', 'step', 'cosine'];

export const configView = {
  mount(root) {
    const store = useTrainingStore();
    const fields = {
      model: el('select'),
      optimizer: el('select', {}, ...OPTIMIZERS.map((o) => el('option', {}, o))),
      scheduler: el('select', {}, ...SCHEDULERS.map((o) => el('option', {}, o))),
      lr: el('input', { class: 'num', value: '0.001' }),
      wd: el('input', { class: 'num', value: '0' }),
      epochs: el('input', { class: 'num', value: '3' }),
      bs: el('input', { class: 'num', value: '64' }),
      n: el('input', { class: 'num', value: '3000' }),
      target: el('input', { class: 'num', placeholder: 'off' }),
    };

    api.getModels().then((d) => {
      fields.model.replaceChildren(...d.models.map((m) => el('option', {}, m)));
    });

    const history = DataTable(
      ['#', 'started', 'model/opt', 'epochs', 'final loss', 'test acc',
       'wall', 'outcome'],
      (run, i) => {
        const c = run.config || {};
        return el('tr', {},
          el('td', {}, String(i)),
          el('td', {}, run.started || ''),
          el('td', {}, `${c.model || 'MNIST_CNN'} / ${c.optimizer || 'adam'}`),
          el('td', {}, String(run.epochs_run)),
          el('td', {}, run.final_loss == null ? '—' : run.final_loss.toFixed(4)),
          el('td', {}, run.test_acc == null ? '—' : `${(100 * run.test_acc).toFixed(1)}%`),
          el('td', {}, `${run.wall_time ?? ''}s`),
          el('td', {}, String(run.outcome)),
        );
      },
    );
    const refreshHistory = () =>
      api.getHistory().then((d) => history.set(d.runs));

    const start = async () => {
      const config = {
        model: fields.model.value,
        optimizer: fields.optimizer.value,
        scheduler: fields.scheduler.value,
        learning_rate: parseFloat(fields.lr.value),
        weight_decay: parseFloat(fields.wd.value) || 0,
        epochs: parseInt(fields.epochs.value, 10),
        batch_size: parseInt(fields.bs.value, 10),
        num_samples: parseInt(fields.n.value, 10),
      };
      if (fields.target.value) config.target_acc = parseFloat(fields.target.value);
      if (config.model === 'dynamic' && layersSignal.value.length) {
        config.layers = layersSignal.value;
      }
      await store.startTraining(config).catch((e) => {
        store.status.value = e.body?.status || e.message;
      });
    };

    root.append(
      Card('training configuration',
        el('div', { class: 'row' },
          ...labeled('model', fields.model),
          ...labeled('optimizer', fields.optimizer),
          ...labeled('scheduler', fields.scheduler)),
        el('div', { class: 'row' },
          ...labeled('lr', fields.lr),
          ...labeled('weight decay', fields.wd),
          ...labeled('epochs', fields.epochs),
          ...labeled('batch size', fields.bs)),
        el('div', { class: 'row' },
          ...labeled('samples', fields.n),
          ...labeled('target acc %', fields.target)),
        el('div', { class: 'row' },
          el('button', { class: 'primary', onClick: start }, 'Start training'),
          el('button', { class: 'ghost', onClick: () => store.stopTraining() },
            'Stop'))),
      Card(null,
        el('h3', {}, 'run history ',
          el('button', { class: 'mini', onClick: refreshHistory }, 'refresh')),
        history.node),
    );
    refreshHistory();
  },
};
