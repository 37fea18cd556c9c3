/* Dashboard view (reference: Visualization_frontend/src/views/dashboard/
 * index.vue — metric cards + ECharts loss/accuracy panels + resource bars).
 * Superset: per-epoch test-accuracy and LR charts, EMA overlay on the
 * loss, epoch wall-time card.
 */

import { LineChart, ema, defaultFormat } from '../charts.js';
import { Card, MetricCard, el } from '../components.js';
import { effect } from '../reactive.js';
import { useTrainingStore } from '../store/training.js';

const pct = (v) => `${(100 * v).toFixed(1)}%`;

export const dashboardView = {
  mount(root) {
    const store = useTrainingStore();
    const cards = {
      loss: MetricCard('train loss'),
      acc: MetricCard('batch acc'),
      tacc: MetricCard('test acc'),
      epoch: MetricCard('epoch / batch'),
      lr: MetricCard('lr'),
      etime: MetricCard('epoch time'),
      cpu: MetricCard('cpu'),
      ram: MetricCard('ram'),
    };
    const panels = {
      loss: el('div'),
      acc: el('div'),
      tacc: el('div'),
      lr: el('div'),
      res: el('div'),
    };
    root.append(
      Card(null, ...Object.values(cards).map((c) => c.node)),
      el(
        'div',
        { class: 'grid2' },
        Card('training loss', panels.loss),
        Card('batch accuracy', panels.acc),
        Card('test accuracy / epoch', panels.tacc),
        Card('learning rate / epoch', panels.lr),
      ),
      Card('host resources (%)', panels.res),
    );

    const css = (name) =>
      getComputedStyle(document.documentElement).getPropertyValue(name).trim();
    const charts = {
      loss: new LineChart(panels.loss, {
        series: [
          { name: 'loss', color: css('--series-muted'), area: true },
          { name: 'ema', color: css('--series-err'), width: 2.2 },
        ],
      }),
      acc: new LineChart(panels.acc, {
        series: [{ name: 'batch acc', color: css('--series-acc') }],
        yDomain: [0, 1],
        yFormat: pct,
      }),
      tacc: new LineChart(panels.tacc, {
        series: [{ name: 'test acc', color: css('--series-ok') }],
        yDomain: [0, 1],
        yFormat: pct,
      }),
      lr: new LineChart(panels.lr, {
        series: [{ name: 'lr', color: css('--series-alt') }],
      }),
      res: new LineChart(panels.res, {
        series: [
          { name: 'cpu %', color: css('--series-muted') },
          { name: 'ram %', color: css('--series-warn') },
        ],
        yDomain: [0, 100],
        yFormat: (v) => v.toFixed(0),
      }),
    };

    const disposers = [
      effect(() => {
        charts.loss.setOption({
          series: [
            { data: store.losses.value },
            { data: ema(store.losses.value) },
          ],
        });
      }, [store.losses]),
      effect(() => {
        charts.acc.setOption({ series: [{ data: store.accs.value }] });
      }, [store.accs]),
      effect(() => {
        charts.tacc.setOption({ series: [{ data: store.testAccs.value }] });
      }, [store.testAccs]),
      effect(() => {
        charts.lr.setOption({ series: [{ data: store.lrs.value }] });
      }, [store.lrs]),
      effect(() => {
        charts.res.setOption({
          series: [{ data: store.cpu.value }, { data: store.ram.value }],
        });
      }, [store.cpu, store.ram]),
      effect(() => {
        const c = store.current.value;
        if (c.loss !== undefined) cards.loss.set(c.loss.toFixed(4));
        if (c.accuracy !== undefined) cards.acc.set(pct(c.accuracy));
        if (c.test_acc !== undefined) cards.tacc.set(pct(c.test_acc));
        if (c.epoch !== undefined) {
          cards.epoch.set(`${c.epoch} / ${c.batch ?? '—'}`);
        }
        if (c.lr !== undefined) cards.lr.set(defaultFormat(c.lr));
        if (c.epoch_time !== undefined) {
          cards.etime.set(`${c.epoch_time.toFixed(1)}s`);
        }
      }, [store.current]),
      effect(() => {
        const n = store.cpu.value.length;
        if (n) {
          cards.cpu.set(`${store.cpu.value[n - 1]}%`);
          cards.ram.set(`${store.ram.value[store.ram.value.length - 1]}%`);
        }
      }, [store.cpu]),
    ];

    return () => {
      disposers.forEach((dispose) => dispose());
      Object.values(charts).forEach((c) => c.dispose());
    };
  },
};
