/* App bootstrap (the reference's main.ts + layout/index.vue + App.vue:
 * mount the layout shell, register routes, open the store's WebSocket).
 */

import { Router } from './router.js';
import { StatusPill, el } from './components.js';
import { useTrainingStore } from './store/training.js';
import { dashboardView } from './views/dashboard.js';
import { builderView } from './views/builder.js';
import { configView } from './views/config.js';
import { effect } from './reactive.js';

const ROUTES = {
  '/dashboard': { title: 'Dashboard', view: dashboardView },
  '/model-builder': { title: 'Model builder', view: builderView },
  '/training-config': { title: 'Training config', view: configView },
};

function layout() {
  const status = StatusPill();
  const nav = el('nav', {},
    ...Object.entries(ROUTES).map(([path, r]) =>
      el('a', { href: '#' + path, dataset: { route: path } }, r.title)));
  const header = el('header', {},
    el('h1', {}, 'deepflows_tpu'), nav, status.node);
  const outlet = el('main');
  document.body.append(header, outlet);
  return { outlet, status };
}

const { outlet, status } = layout();
const store = useTrainingStore();
store.initWebSocket();

effect(() => {
  // the run status wins over transient socket states once training starts
  if (store.status.value !== 'idle') status.set(store.status.value);
  else if (store.wsState.value !== 'open') status.set(store.wsState.value);
  else status.set('idle');
}, [store.status, store.wsState]);

new Router(outlet, ROUTES).start();
